"""One-class training CLI (port of `occm_tpu.cli.oc_training`): the same
flags and defaults, plus --device.

Trains XLSR + AASIST (`--model aasist`) on one GPU and writes the
reference's per-epoch checkpoints `<checkpoint_dir>/aasist_vocoded_<e>.pt`
(a torch state dict in the reference naming, which
`occm_tpu_torch.cli.oc_server --pretrained-sslaasist` loads, next to the
optimizer state). `--init_from` takes such a .pt file. `--grad_accum`,
`--lr_schedule` (with `--warmup_steps`, `--decay_steps`, `--lr_end_ratio`),
`--steps_per_dispatch` (one CUDA graph per chunk on a card),
`--checkpoint_every_steps` (and the SIGTERM save) and `--resume` act as in
the JAX package. Every flag whose code path is not ported yet raises
NotImplementedError at a non-default value, naming the ROADMAP item that
ports it.

Usage:
    python -m occm_tpu_torch.cli.oc_training \
        --train_protocol_file ... --train_dataset_dir ... --model aasist
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a model on a dataset")
    parser.add_argument(
        "--train_dataset_dir", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof2019_LA_train/wav",
    )
    parser.add_argument(
        "--test_dataset_dir", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof2019_LA_eval/flac",
    )
    parser.add_argument("--model", type=str, default="aasist",
                        choices=["aasist", "ssl_resnet34", "ssl_lcnn",
                                 "ssl_lcnn_asoftmax", "occm", "cnn"])
    parser.add_argument("--finetuned", action="store_true", default=False)
    parser.add_argument(
        "--train_protocol_file", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof_LA_cm_protocols/"
                "ASVspoof2019.LA.cm.train.trn.txt",
    )
    parser.add_argument(
        "--test_protocol_file", type=str,
        default="/datab/Dataset/ASVspoof/LA/ASVspoof_LA_cm_protocols/"
                "ASVspoof2019.LA.cm.eval.trl.txt",
    )
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument("--compactness_weight", type=float, default=0.0)
    parser.add_argument("--descriptiveness_weight", type=float, default=1.0)
    parser.add_argument("--groups_per_step", type=int, default=1)
    parser.add_argument("--cut", type=int, default=64600)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--vocoded_dir", type=str, default=None)
    parser.add_argument("--checkpoint_dir", type=str, default=".")
    parser.add_argument("--dp", type=int, default=-1)
    parser.add_argument("--fsdp", type=int, default=1,
                        help="not ported yet (one GPU)")
    parser.add_argument("--tp", type=int, default=1,
                        help="not ported yet (one GPU)")
    parser.add_argument("--pp", type=int, default=1,
                        help="not ported yet (one GPU)")
    parser.add_argument("--seq_parallel", action="store_true", default=False,
                        help="not ported yet (one GPU)")
    parser.add_argument("--pp_microbatches", type=int, default=0,
                        help="not ported yet (one GPU)")
    parser.add_argument("--rawboost_algo", type=int, default=0,
                        help="0 disables; 1-8 are not ported yet")
    parser.add_argument("--wandb_project", type=str, default=None,
                        help="not ported yet")
    parser.add_argument("--xlsr_tiny", action="store_true",
                        help="tiny XLSR config (CPU smoke runs)")
    parser.add_argument("--pretrained_xlsr", type=str, default=None,
                        help="not ported yet")
    parser.add_argument(
        "--init_from", type=str, default=None,
        help="full-model warm start from a torch .pt state dict in the "
             "reference naming (a trainer checkpoint, aasist_vocoded_*.pt, "
             "or occm-export-model output); the optimizer starts fresh")
    parser.add_argument("--fast_numerics", action="store_true",
                        default=False, help="not ported yet")
    parser.add_argument("--pos_conv_impl", type=str, default="grouped",
                        choices=("grouped", "batched", "s2d"),
                        help="only grouped is ported")
    parser.add_argument(
        "--attention_impl", type=str, default="auto",
        help='"auto" (default) resolves from --cut through '
             "occm_tpu_torch.classify.impl_select (the flash kernels from "
             '5 s up); or pin xla | flash')
    parser.add_argument(
        "--steps_per_dispatch", type=int, default=1,
        help="k optimizer steps per dispatch: on a card one CUDA graph "
             "launch per chunk of k full batches (ragged batches are "
             "flushed as single steps, in data order)")
    parser.add_argument(
        "--feature_grad_mult", type=float, default=1.0,
        help="scale (0 stops) the gradient into the conv feature "
             "extractor (fairseq's GradMultiply)")
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the latest checkpoint of --checkpoint_dir (an "
             "epoch, or a newer step checkpoint, whose epoch is replayed "
             "up to it)")
    parser.add_argument(
        "--checkpoint_every_steps", type=int, default=0,
        help="save a step checkpoint every N optimizer steps (and on "
             "SIGTERM); --resume continues bit-identically from it. 0 = "
             "per-epoch only")
    parser.add_argument("--debug_nans", action="store_true",
                        help="not ported yet")
    parser.add_argument(
        "--grad_accum", type=int, default=1,
        help="accumulate gradients over N micro-batches (whole "
             "meta-batches each) before one optimizer update, equal to the "
             "big-batch update; groups_per_step must be divisible by N")
    parser.add_argument(
        "--lr_schedule", type=str, default="constant",
        choices=["constant", "cosine", "linear"],
        help="lr schedule over optimizer steps (constant = the reference's "
             "fixed lr; cosine / linear: warmup over --warmup_steps, then "
             "decay over --decay_steps to lr * --lr_end_ratio; adam only)")
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--decay_steps", type=int, default=0)
    parser.add_argument("--lr_end_ratio", type=float, default=0.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help='torch device: "cuda" (default) or "cpu"')
    return parser


def _unported(args) -> None:
    """Raise on a flag whose code path is not ported, naming its item of
    ROADMAP queue A. (TrainConfig, MeshConfig and XLSRConfig raise on the
    fields they carry.)"""
    checks = [
        ("--model", args.model != "aasist", "the other models"),
        ("--pretrained_xlsr", args.pretrained_xlsr is not None,
         "--pretrained_xlsr"),
        ("--fast_numerics", args.fast_numerics, "remat_policy variants"),
        ("--seq_parallel", args.seq_parallel, "multi-GPU"),
        ("--pp_microbatches", args.pp_microbatches != 0, "multi-GPU"),
        ("--debug_nans", args.debug_nans, "remaining features"),
        ("--rawboost_algo", args.rawboost_algo != 0, "RawBoost in the step"),
    ]
    for flag, set_, item in checks:
        if set_:
            raise NotImplementedError(
                f"{flag} is not ported to occm_tpu_torch yet (ROADMAP queue "
                f"A: {item})")


def xlsr_config(args, cut: int, device):
    """The model's XLSRConfig from the flags (--xlsr_tiny, --pos_conv_impl,
    --feature_grad_mult), with the attention impl that --attention_impl
    resolves to for crops of `cut` samples of that model on `device`."""
    from occm_tpu_torch.classify.impl_select import (
        flash_kernel_takes, select_attention_impl)
    from occm_tpu_torch.config import XLSRConfig

    xlsr_cfg = XLSRConfig.tiny() if args.xlsr_tiny else XLSRConfig()
    if args.pos_conv_impl != "grouped":
        xlsr_cfg = dataclasses.replace(xlsr_cfg,
                                       pos_conv_impl=args.pos_conv_impl)
    if args.feature_grad_mult != 1.0:
        xlsr_cfg = dataclasses.replace(
            xlsr_cfg, feature_grad_mult=args.feature_grad_mult)
    impl = select_attention_impl(
        cut, args.attention_impl, norm_dtype=xlsr_cfg.norm_dtype,
        flash_takes_model=flash_kernel_takes(xlsr_cfg, device))
    if impl != xlsr_cfg.attention_impl:
        xlsr_cfg = dataclasses.replace(xlsr_cfg, attention_impl=impl)
    return xlsr_cfg


def build_model(xlsr_cfg, seed: int, init_from=None):
    """AModel with PyTorch's default initialisation drawn from a generator
    seeded with `seed` (the global one, forked so the caller's stream is
    untouched), or the weights of a reference-named .pt file."""
    import torch

    from occm_tpu_torch.config import AASISTConfig
    from occm_tpu_torch.models import AModel, load_reference_state_dict

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = AModel(AASISTConfig(), xlsr_cfg=xlsr_cfg)
    if init_from:
        if not init_from.endswith(".pt"):
            raise NotImplementedError(
                "--init_from takes a torch .pt state dict; orbax "
                "directories are not ported (ROADMAP queue A: "
                "--pretrained_xlsr)")
        model.load_state_dict(load_reference_state_dict(init_from),
                              strict=True)
        print(f"Warm start from {init_from}")
    return model


def main(argv=None, on_step=None):
    """on_step(step, metrics): optional hook after every dispatch (used by
    chip_smoke.py to count kernel launches per step)."""
    args = build_parser().parse_args(argv)
    _unported(args)

    from occm_tpu_torch.config import MeshConfig, RawBoostConfig, TrainConfig

    cfg = TrainConfig(
        model=args.model,
        checkpoint_prefix=f"{args.model}_vocoded",
        lr=args.lr,
        num_epochs=args.num_epochs,
        compactness_weight=args.compactness_weight,
        descriptiveness_weight=args.descriptiveness_weight,
        seed=args.seed,
        cut=args.cut,
        groups_per_step=args.groups_per_step,
        rawboost=RawBoostConfig(algo=args.rawboost_algo),
        mesh=MeshConfig(dp=args.dp, fsdp=args.fsdp, tp=args.tp, pp=args.pp),
        checkpoint_dir=args.checkpoint_dir,
        wandb_project=args.wandb_project,
        steps_per_dispatch=args.steps_per_dispatch,
        checkpoint_every_steps=args.checkpoint_every_steps,
        grad_accum=args.grad_accum,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps,
        lr_end_ratio=args.lr_end_ratio,
    )
    from occm_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    xlsr_cfg = xlsr_config(args, cfg.cut, device)

    print("*************************************************")
    print(f"Train dataset dir = {args.train_dataset_dir}")
    print(f"Test dataset dir = {args.test_dataset_dir}")
    print(f"model = {args.model}")
    print(f"finetuned = {args.finetuned}")
    print(f"train_protocol_file = {args.train_protocol_file}")
    print(f"test_protocol_file = {args.test_protocol_file}")
    print("*************************************************")

    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.train.checkpoint import save_checkpoint
    from occm_tpu_torch.train.loop import train

    dataset = PFDataset(args.train_protocol_file,
                        dataset_dir=args.train_dataset_dir,
                        vocoded_dir=args.vocoded_dir, cut=cfg.cut,
                        seed=cfg.seed)
    pipeline = MetaBatchPipeline(dataset, groups_per_step=cfg.groups_per_step,
                                 seed=cfg.seed)

    model = build_model(xlsr_cfg, cfg.seed, args.init_from)

    prefix = cfg.checkpoint_prefix  # reference naming: aasist_vocoded_{e}

    def checkpoint_fn(state, epoch):
        print("Saving the models...")
        save_checkpoint(state, cfg.checkpoint_dir, prefix, epoch)

    print("Training starts...")
    return train(model, pipeline, cfg, checkpoint_fn=checkpoint_fn,
                 device=device, on_step=on_step, resume=args.resume)


if __name__ == "__main__":
    main()
