"""EER CLI for `utt score` files (port of `occm_tpu.cli.calculate_eer`,
same flags and printed lines; reference: calculate_eer.py:28-39).

Beyond-reference: `--asv_score_file` additionally reports the normalized
minimum t-DCF (ASVspoof's official primary metric, which the reference
lacks — see occm_tpu_torch/metrics/tdcf.py). Default behaviour and output
are unchanged when the flag is absent.
"""

from __future__ import annotations

import argparse

from occm_tpu_torch.evaluate import calculate_eer_merged, calculate_tdcf_merged


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="EER (and optionally min t-DCF) from utt-score files "
                    "merged with a 5-col protocol"
    )
    parser.add_argument(
        "--eval_protocol_file", type=str,
        default="./database/protocols/PartialSpoof_LA_cm_protocols/"
                "PartialSpoof.LA.cm.eval.trl.txt",
    )
    parser.add_argument(
        "--score_file", type=str, default="./se_resnet34_eval_scores.txt"
    )
    parser.add_argument(
        "--asv_score_file", type=str, default=None,
        help="official-format ASV score file (`... key score` rows, key in "
             "target|nontarget|spoof); when given, also print the "
             "normalized minimum t-DCF at the ASV EER operating point",
    )
    parser.add_argument(
        "--tdcf_version", type=str, default="v2", choices=("v1", "v2"),
        help="t-DCF revision: v1 = ASVspoof2019 evaluation plan, "
             "v2 = 2020 constant-offset restatement (default)",
    )
    args = parser.parse_args(argv)

    print(f"eval_protocol_file = {args.eval_protocol_file}")
    print(f"score_file = {args.score_file}")
    eer, threshold = calculate_eer_merged(
        args.eval_protocol_file, args.score_file
    )
    print(f"EER = {eer * 100.0}, threshold = {threshold}")

    if args.asv_score_file is not None:
        min_tdcf, cm_threshold = calculate_tdcf_merged(
            args.eval_protocol_file, args.score_file,
            args.asv_score_file, version=args.tdcf_version,
        )
        print(
            f"min t-DCF ({args.tdcf_version}) = {min_tdcf:.6f}, "
            f"CM threshold = {cm_threshold}"
        )


if __name__ == "__main__":
    main()
