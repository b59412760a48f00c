"""One-class classifier / scoring CLI (port of `occm_tpu.cli.oc_classifier`;
flag-compatible with the reference, oc_classifier.py:316-331).

Phase 1 builds the bonafide reference embedding + threshold (cached as
reference_embedding.npy / threshold.npy in the working directory, the
artefacts `occm_tpu_torch.cli.oc_server` serves from); phase 2 scores the
eval set with the selected mode (1c2 default, reference:
oc_classifier.py:358). The flags are the JAX CLI's, plus --device;
--pretrained-sslaasist takes a torch state dict in the reference's naming
(what `occm_tpu_torch.cli.oc_training` writes) in place of an orbax
directory. Modes 1c2 and 2c2 run the full AModel; 1c1 and 2c1,
--quant_int8 and --data_parallel raise NotImplementedError.

Usage:
    python -m occm_tpu_torch.cli.oc_classifier \\
        --pretrained-sslaasist aasist_vocoded_99.pt \\
        --protocol_file train.trn.txt --dataset_dir train/flac \\
        --eval_protocol_file eval.trl.txt --eval_dataset_dir eval/flac
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="One-class classifier (PyTorch/CUDA)")
    parser.add_argument("--pretrained-sslaasist", type=str,
                        default="aasist_vocoded_1.pt",
                        help="torch state dict of the full AModel in the "
                             "reference's naming (oc_training's .pt)")
    parser.add_argument("--pretrained-ssl", type=str, default=None,
                        help="modes 1c1/2c1 only (not ported yet)")
    parser.add_argument("--pretrained-senet", type=str, default=None,
                        help="modes 1c1/2c1 only (not ported yet)")
    parser.add_argument(
        "--protocol_file", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof_LA_cm_protocols/"
                "ASVspoof2019.LA.cm.train.trn.txt",
    )
    parser.add_argument(
        "--dataset_dir", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof2019_LA_train/flac",
    )
    parser.add_argument(
        "--eval_protocol_file", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof_LA_cm_protocols/"
                "ASVspoof2019.LA.cm.eval.trl.txt",
    )
    parser.add_argument(
        "--eval_dataset_dir", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof2019_LA_eval/flac",
    )
    parser.add_argument("--mode", type=str, default="1c2",
                        choices=["1c1", "1c2", "2c1", "2c2"],
                        help="scoring mode (reference: "
                             "oc_classifier.py:206-312); 1c1/2c1 are not "
                             "ported yet")
    parser.add_argument("--score_file", type=str, default="scores.txt")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--bucket_step", type=int, default=16000)
    parser.add_argument(
        "--decode_threads", type=int, default=8,
        help="threads of the native decode lane (not ported yet: files "
             "decode in Python, the same waves)")
    parser.add_argument("--data_parallel", type=int, default=0, metavar="N",
                        help="not ported yet: scoring runs on one GPU")
    parser.add_argument("--xlsr_tiny", action="store_true")
    parser.add_argument(
        "--attention_impl", type=str, default="auto",
        help='attention per length bucket: "auto" (default) resolves per '
             "bucket (occm_tpu_torch.classify.impl_select: xla short, the "
             "flash kernel long); or pin xla | flash for every bucket")
    parser.add_argument(
        "--fast_numerics", action="store_true", default=False,
        help="bf16 norms + tanh GELU scoring (validate EER impact first)")
    parser.add_argument("--quant_int8", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument(
        "--allow_random_init", action="store_true",
        help="score seeded random weights if the checkpoint cannot be read "
             "(testing only — a real scoring run must hard-fail)")
    parser.add_argument("--device", type=str, default="cuda",
                        help='torch device: "cuda" (default) or "cpu"')
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from occm_tpu_torch.classify import (
        BucketedEmbedder, OneClassScorer, make_embed_fn_factory)
    from occm_tpu_torch.cli.oc_server import build_model, xlsr_config
    from occm_tpu_torch.data import ASVDataset
    from occm_tpu_torch.utils.device import resolve_device

    if args.mode in ("1c1", "2c1"):
        raise NotImplementedError(
            f"--mode {args.mode} needs SSLResNet34 (the separate extractor "
            "and SE-ResNet34 encoder), not ported to occm_tpu_torch yet "
            "(ROADMAP queue A item 8)")
    if args.quant_int8:
        raise NotImplementedError(
            "--quant_int8 is not ported to occm_tpu_torch yet (ROADMAP "
            "queue A item 14)")
    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel is not ported to occm_tpu_torch yet (ROADMAP "
            "queue A item 15)")
    device = resolve_device(args.device)

    xlsr_cfg = xlsr_config(args.xlsr_tiny, args.fast_numerics)
    model = build_model(xlsr_cfg, args.pretrained_sslaasist,
                        args.allow_random_init, device)
    embedder = BucketedEmbedder(
        embed_fn_factory=make_embed_fn_factory(
            model, args.attention_impl, xlsr_cfg.norm_dtype),
        bucket_step=args.bucket_step, batch_size=args.batch_size,
        device=device)
    scorer = OneClassScorer(embedder)

    train_dataset = ASVDataset(args.protocol_file, args.dataset_dir)
    eval_dataset = ASVDataset(args.eval_protocol_file,
                              args.eval_dataset_dir, eval=True)

    if args.mode == "1c2":
        reference, threshold = scorer.create_reference_embedding(
            train_dataset, verbose=True)
        scorer.score_eval_set_1c(eval_dataset, reference, threshold,
                                 score_file=args.score_file, verbose=True)
        print(f"threshold = {threshold}")
    else:
        scorer.score_eval_set_2c(eval_dataset, score_file=args.score_file,
                                 verbose=True)


if __name__ == "__main__":
    main()
