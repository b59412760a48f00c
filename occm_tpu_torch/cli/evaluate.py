"""Score evaluation CLI (port of `occm_tpu.cli.evaluate`, same flags and
printed lines; reference: evaluate.py:148-198): comma-format scores + bare
protocol + trial metadata -> confusion matrix + EER."""

from __future__ import annotations

import argparse

from occm_tpu_torch.evaluate import evaluate_scores


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--score_file", type=str, default="score.txt")
    parser.add_argument("--protocol_file", type=str, default="protocol.txt")
    parser.add_argument("--metadata_file", type=str, default="metadata.txt")
    parser.add_argument("--threshold", type=float, default=0.1)
    args = parser.parse_args(argv)

    res = evaluate_scores(
        args.score_file, args.protocol_file, args.metadata_file,
        args.threshold,
    )
    print(f"bona fide = {res['bona_fide']}")
    print(f"spoof = {res['spoof']}")
    cm = res["confusion_matrix"]
    print(cm)
    print(f"TP = {cm[0][0]}")
    print(f"TN = {cm[1][1]}")
    print(f"FP = {cm[0][1]}")
    print(f"FN = {cm[1][0]}")
    print(f"EER = {res['eer'] * 100.0}, threshold = {res['eer_threshold']}")


if __name__ == "__main__":
    main()
