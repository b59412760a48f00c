"""One-class classifier / scoring CLI (port of `occm_tpu.cli.oc_classifier`;
flag-compatible with the reference, oc_classifier.py:316-331).

Phase 1 builds the bonafide reference embedding + threshold (cached as
reference_embedding.npy / threshold.npy in the working directory, the
artefacts `occm_tpu_torch.cli.oc_server` serves from); phase 2 scores the
eval set with the selected mode (1c2 default, reference:
oc_classifier.py:358). The flags are the JAX CLI's, plus --device. Each
weight flag takes a torch state dict in the reference's naming (what
`occm_tpu_torch.cli.oc_training` writes) or an orbax directory of the JAX
package (a trainer epoch directory or an `occm-convert-model` save, read
without orbax by `occm_tpu_torch.train.orbax`), as the JAX CLI's do.
Modes 1c2 and 2c2 run the full AModel from --pretrained-sslaasist. Modes
1c1 and 2c1 run SSLResNet34 (the separate extractor and SE-ResNet34
encoder), loaded from --pretrained-ssl alone (a fused ssl_resnet34
checkpoint, as `oc_training --model ssl_resnet34` writes;
--pretrained-sslaasist when --pretrained-ssl is unset), or from the
reference's separate pair (reference: oc_classifier.py:340-342):
--pretrained-ssl an ssl_vocoded checkpoint (the SSLModel, model.*) into the
frontend and --pretrained-senet a senet34_vocoded one into the encoder,
statistics included. --quant_int8 scores with the W8A8 int8 transformer
projections in every mode, quantised from the fp32 checkpoint at load
time (on XLS-R it needs --fast_numerics); --data_parallel N scores data-parallel over N local
GPUs, with any of the other flags.

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
                        help="the full AModel: a torch state dict in the "
                             "reference's naming (oc_training's .pt) or an "
                             "orbax directory of the JAX package")
    parser.add_argument("--pretrained-ssl", type=str, default=None,
                        help="modes 1c1/2c1: a fused ssl_resnet34 .pt or "
                             "orbax directory, or with --pretrained-senet "
                             "an ssl_vocoded one (SSLModel, model.*) for "
                             "the frontend")
    parser.add_argument("--pretrained-senet", type=str, default=None,
                        help="modes 1c1/2c1, with --pretrained-ssl: a "
                             "senet34_vocoded .pt or orbax directory for "
                             "the SE-ResNet34 encoder")
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
                             "oc_classifier.py:206-312)")
    parser.add_argument("--score_file", type=str, default="scores.txt")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--bucket_step", type=int, default=16000)
    parser.add_argument(
        "--decode_threads", type=int, default=8,
        help="threads of the native batch decode (header length probes "
             "and one threaded C++ decode per batch; files decode in Python "
             "where the native library is unavailable)")
    parser.add_argument(
        "--data_parallel", type=int, default=0, metavar="N",
        help="score data-parallel over N local GPUs (-1: all of them): the "
             "model replicated on each, every batch split over them (the "
             "reference's DataParallel, oc_classifier.py:343); 0 = one "
             "device")
    parser.add_argument("--xlsr_tiny", action="store_true")
    parser.add_argument(
        "--attention_impl", type=str, default="auto",
        help='attention per length bucket: "auto" (default) resolves per '
             "bucket (occm_tpu_torch.classify.impl_select: xla short, the "
             "flash kernel long); or pin xla | flash for every bucket")
    parser.add_argument(
        "--fast_numerics", action="store_true", default=False,
        help="bf16 norms + tanh GELU scoring (validate EER impact first)")
    parser.add_argument(
        "--quant_int8", action="store_true", default=False,
        help="W8A8 int8 transformer projections, quantised from the fp32 "
             "checkpoint at load time (XLS-R: with --fast_numerics)")
    parser.add_argument(
        "--allow_random_init", action="store_true",
        help="score seeded random weights if the checkpoint cannot be read "
             "(testing only — a real scoring run must hard-fail)")
    parser.add_argument("--device", type=str, default="cuda",
                        help='torch device: "cuda" (default) or "cpu"')
    return parser


def build_ssl_resnet34(xlsr_cfg, ssl, senet, sslaasist,
                       allow_random_init: bool, device):
    """SSLResNet34 on `device` in eval mode for modes 1c1/2c1: from the
    fused checkpoint `ssl or sslaasist` (a .pt or an orbax directory), or,
    when both `ssl` and `senet` are given, from the separate pair (the
    SSLModel's state dict into `frontend`, the SE-ResNet's into
    `resnet34`); every load is strict. A
    missing file fails before the model is built; with `allow_random_init`
    a file that cannot be loaded gives seeded random weights (seed 0).
    With xlsr_cfg.quant_int8 the fp32 weights are then quantised."""
    import dataclasses
    import os

    from occm_tpu_torch.cli.oc_server import quantize_model_int8
    from occm_tpu_torch.models import SSLResNet34, detect_model_kind
    from occm_tpu_torch.models.convert_backend import state_dict_from_path
    from occm_tpu_torch.utils.init_template import random_init_

    pair = bool(ssl and senet)
    ckpt = ssl or sslaasist
    if not allow_random_init:
        for path in ([ssl, senet] if pair else [ckpt]):
            if not os.path.exists(path):
                raise SystemExit(
                    f"ERROR: could not restore pretrained weights: "
                    f"checkpoint {path!r} does not exist.\n"
                    "Pass --allow_random_init to score with random weights "
                    "(testing only).")

    def load(path, want, into):
        state = state_dict_from_path(path, model.xlsr_cfg, into=into)
        kind = detect_model_kind(state)
        if kind != want:
            raise ValueError(f"{path!r} holds a {kind} checkpoint, not "
                             f"{want}")
        return state

    model = SSLResNet34(
        xlsr_cfg=dataclasses.replace(xlsr_cfg, quant_int8=False))
    try:
        if pair:
            model.frontend.load_state_dict(
                load(ssl, "ssl", model.frontend), strict=True)
            model.resnet34.load_state_dict(
                load(senet, "senet", model.resnet34), strict=True)
        else:
            model.load_state_dict(load(ckpt, "ssl_resnet34", model),
                                  strict=True)
        print("Pretrained weights loaded")
    except (OSError, RuntimeError, KeyError, ValueError) as e:
        if not allow_random_init:
            raise SystemExit(
                f"ERROR: could not restore pretrained weights from "
                f"{ckpt!r}: {e}\nPass --allow_random_init to score with "
                "random weights (testing only).")
        print(f"WARNING: could not restore pretrained weights ({e}); "
              "using random init (--allow_random_init)")
        random_init_(model, seed=0)
    if xlsr_cfg.quant_int8:
        model = quantize_model_int8(
            model, lambda cfg: SSLResNet34(xlsr_cfg=cfg))
    return model.to(device).eval()


def main(argv=None):
    args = build_parser().parse_args(argv)

    from occm_tpu_torch.classify import (
        BucketedEmbedder, OneClassScorer, make_embed_fn_factory)
    from occm_tpu_torch.cli.oc_server import build_model, xlsr_config
    from occm_tpu_torch.data import ASVDataset
    from occm_tpu_torch.utils.device import resolve_device

    xlsr_cfg = xlsr_config(args.xlsr_tiny, args.fast_numerics,
                           args.quant_int8)
    device = resolve_device(args.device)
    mesh = None
    if args.data_parallel:
        from occm_tpu_torch.classify import make_dp_mesh

        # -1: every local device (make_dp_mesh raises for more than exist)
        n = None if args.data_parallel == -1 else args.data_parallel
        mesh = make_dp_mesh(n, device_type=device.type)
        device = mesh.devices[0]
        print(f"scoring data-parallel over {mesh.size} devices")

    if args.mode in ("1c1", "2c1"):
        model = build_ssl_resnet34(
            xlsr_cfg, args.pretrained_ssl, args.pretrained_senet,
            args.pretrained_sslaasist, args.allow_random_init, device)
    else:
        model = build_model(xlsr_cfg, args.pretrained_sslaasist,
                            args.allow_random_init, device)
    embedder = BucketedEmbedder(
        embed_fn_factory=make_embed_fn_factory(
            model, args.attention_impl, mesh=mesh),
        bucket_step=args.bucket_step, batch_size=args.batch_size,
        mesh=mesh, device=device, decode_threads=args.decode_threads)
    scorer = OneClassScorer(embedder)

    train_dataset = ASVDataset(args.protocol_file, args.dataset_dir)
    eval_dataset = ASVDataset(args.eval_protocol_file,
                              args.eval_dataset_dir, eval=True)

    if args.mode in ("1c1", "1c2"):
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
