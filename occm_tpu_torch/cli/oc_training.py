"""One-class training CLI (port of `occm_tpu.cli.oc_training`): the same
flags and defaults, plus --device.

Trains one of the JAX CLI's models on one GPU or a rank mesh: XLSR + AASIST (`--model
aasist`), SSLResNet34 (`ssl_resnet34`), SSLLCNN with the Linear head
(`ssl_lcnn`) or the A-softmax head and the angle loss
(`ssl_lcnn_asoftmax`), TotalCNNNet (`cnn`) or the dual-branch OCCM
(`occm`), each with its output kind's loss (`make_model`). It writes the
reference's per-epoch checkpoints `<checkpoint_dir>/<model>_vocoded_<e>.pt`
(a torch state dict in the reference naming, next to the optimizer
state; `occm_tpu_torch.cli.oc_server --pretrained-sslaasist` loads an
aasist one, `oc_classifier --pretrained-ssl` an ssl_resnet34 one).
`--init_from` takes such a .pt file of the chosen model, or an orbax
directory of the JAX package (a trainer epoch directory, an
`occm-convert-model` save or a bare parameter tree, read without orbax by
`occm_tpu_torch.train.orbax`); `--pretrained_xlsr` a fairseq or HF wav2vec2
/ XLS-R checkpoint (.pt, .bin, .safetensors) or an `occm-convert-xlsr`
directory, grafted into the SSL frontend (`ssl_model.model` of aasist,
`frontend.model` of the others) of the model built from --seed (it wins
over --init_from, as in the JAX package). `--rawboost_algo` 1-8 augments
every step's batch on the device. `--grad_accum`, `--lr_schedule` (with
`--warmup_steps`, `--decay_steps`, `--lr_end_ratio`),
`--optimizer` (adam, or the fused_adam kernel; TrainConfig's field, which
the JAX CLI leaves at adam), `--steps_per_dispatch` (one CUDA graph per
chunk on a card), `--checkpoint_every_steps` (and the SIGTERM save) and
`--resume` act as in the JAX package; `--resume` also continues a JAX
run from its epoch or step orbax directories in --checkpoint_dir
(`train.checkpoint`), and the .pt files the port writes beside them win
on the next --resume. `--dp`, `--fsdp`, `--tp` and `--pp` lay the ranks
of a
`torchrun --nproc_per_node N` launch out as a mesh (NCCL, one GPU per
rank; `--device cpu`: Gloo): each rank loads its shard of the epoch and
trains its shards of the model (`occm_tpu_torch.parallel`). `--pp N`
sets both the mesh's pp and the model's pp_stages (the GPipe schedule
over N stages of the XLSR layers, `--pp_microbatches` microbatches, 0
meaning N; ignored without `--pp`, as in JAX; `train()` also takes a
model of pp_stages any multiple of the mesh's pp, each rank running its
block of stages); `--seq_parallel` runs the
layers' residual path on 1/tp of the frames under `--tp`.
`--pos_conv_impl` and `--attention_impl` take every layout of the JAX
package (`--attention_impl packed4`, say). `--debug_nans` stops at the
first step with a NaN in its loss, gradients or updated parameters
(FloatingPointError), before its checkpoint; `--wandb_project` logs the
running averages to wandb as well, where wandb can start.

Usage:
    python -m occm_tpu_torch.cli.oc_training \
        --train_protocol_file ... --train_dataset_dir ... --model aasist
"""

from __future__ import annotations

import argparse
import dataclasses
import os


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
    parser.add_argument(
        "--dp", type=int, default=-1,
        help="data-parallel ranks (-1: what fsdp x tp leave of the world); "
             "launch N ranks with torchrun --nproc_per_node N")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="ZeRO-3 sharding degree of parameters and Adam "
                             "moments (the batch shards over it too)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree of the XLSR layers "
                             "(heads and FFN columns)")
    parser.add_argument(
        "--pp", type=int, default=1,
        help="pipeline stages: the GPipe schedule over the XLSR layers, "
             "stage s of each pipeline owning its block of layers (must "
             "divide encoder_layers)")
    parser.add_argument(
        "--seq_parallel", action="store_true", default=False,
        help="Megatron sequence parallelism under --tp: each layer's "
             "residual path (LayerNorms, dropouts, residual adds) on 1/tp "
             "of the frames, the tp all-reduces replaced by frame "
             "all-gathers and reduce-scatters; not with --pp")
    parser.add_argument(
        "--pp_microbatches", type=int, default=0,
        help="microbatches of the pipeline schedule (0 = pp); more shrink "
             "the (pp - 1) / (M + pp - 1) bubble; must divide a rank's "
             "rows")
    parser.add_argument(
        "--rawboost_algo", type=int, default=0, choices=range(9),
        help="RawBoost in every step: 0 disables; 1 LnL, 2 ISD, 3 SSI, "
             "4 (1+2+3), 5 (1+2), 6 (1+3), 7 (2+3), 8 (1||2)")
    parser.add_argument(
        "--wandb_project", type=str, default=None,
        help="also log the running averages to this wandb project (without "
             "wandb, or when its run cannot start, loss.txt and "
             "metrics.jsonl only)")
    parser.add_argument("--xlsr_tiny", action="store_true",
                        help="tiny XLSR config (CPU smoke runs)")
    parser.add_argument(
        "--pretrained_xlsr", type=str, default=None,
        help="graft a pretrained wav2vec2 / XLS-R encoder into the SSL "
             "frontend: a fairseq checkpoint (xlsr2_300m.pt), a "
             "HuggingFace one (.pt / .bin / .safetensors), or an orbax "
             "directory of occm-convert-xlsr; wins over --init_from")
    parser.add_argument(
        "--init_from", type=str, default=None,
        help="full-model warm start from a torch .pt state dict in the "
             "reference naming (a trainer checkpoint, aasist_vocoded_*.pt, "
             "or occm-export-model output) or an orbax directory of the "
             "JAX package (a trainer epoch directory, occm-convert-model "
             "output, a bare parameter tree); the optimizer starts fresh")
    parser.add_argument(
        "--fast_numerics", action="store_true", default=False,
        help="the JAX package's fast config: bf16 norms, tanh GELU "
             "(transformer and conv extractor), the bf16 parameter mirror "
             "and the 'attn_out_inner' remat policy (on an H100 at 700 W, "
             "every kernel, a 12 x 6 s step as a CUDA graph: ~132 ms "
             "against ~137 ms exact with the same policy, chip_smoke.py "
             "phase 13)")
    parser.add_argument("--pos_conv_impl", type=str, default="grouped",
                        choices=("grouped", "batched", "s2d"),
                        help="the positional conv's layout (the same "
                             "parameters and function)")
    parser.add_argument(
        "--attention_impl", type=str, default="auto",
        help='"auto" (default) resolves from --cut through '
             "occm_tpu_torch.classify.impl_select (the flash kernels from "
             '1 s up, where the model is one they take); or pin xla | '
             "flash | xla_merged | packed[N] | pad128")
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
             "up to it): the port's <model>_vocoded_<e>.pt / _step_<n>.pt "
             "or the JAX package's orbax directories <model>_vocoded_<e>/ "
             "/ _step_<n>/ (parameters, BatchNorm statistics, Adam's "
             "moments, step and progress; the newest wins, a .pt on a "
             "tie). A JAX run's dropout stream is not carried over: the "
             "generator is seeded from --seed and the step. A directory of "
             "weights only, or of another --optimizer / --lr_schedule, "
             "raises")
    parser.add_argument(
        "--checkpoint_every_steps", type=int, default=0,
        help="save a step checkpoint every N optimizer steps (and on "
             "SIGTERM); --resume continues bit-identically from it. 0 = "
             "per-epoch only")
    parser.add_argument(
        "--debug_nans", action="store_true",
        help="raise FloatingPointError at the first step whose loss, "
             "gradients or updated parameters hold a NaN, naming the "
             "tensor, before that step's checkpoint (JAX's "
             "jax_debug_nans)")
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
    parser.add_argument(
        "--optimizer", type=str, default="adam",
        choices=["adam", "fused_adam"],
        help="adam (torch.optim.Adam, the JAX package's optax adam) or "
             "fused_adam (the single-pass CUDA kernel; a constant lr only), "
             "TrainConfig.optimizer")
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--decay_steps", type=int, default=0)
    parser.add_argument("--lr_end_ratio", type=float, default=0.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help='torch device: "cuda" (default) or "cpu"')
    return parser


def xlsr_config(args, cut: int, device):
    """The model's XLSRConfig from the flags (--xlsr_tiny, --fast_numerics,
    --pos_conv_impl, --feature_grad_mult, --pp, --pp_microbatches,
    --seq_parallel), with the attention impl that
    --attention_impl resolves to for crops of `cut` samples of that model
    on `device`."""
    from occm_tpu_torch.classify.impl_select import (
        auto_flash_min_samples, select_attention_impl)
    from occm_tpu_torch.config import XLSRConfig

    xlsr_cfg = XLSRConfig.tiny() if args.xlsr_tiny else XLSRConfig()
    if args.fast_numerics:
        # the JAX CLI's five fields (occm_tpu/cli/oc_training.py:255-260)
        xlsr_cfg = dataclasses.replace(
            xlsr_cfg, norm_dtype="bfloat16", gelu_approximate=True,
            conv_gelu_approximate=True, bf16_param_mirror=True,
            remat_policy="attn_out_inner")
    if args.pos_conv_impl != "grouped":
        xlsr_cfg = dataclasses.replace(xlsr_cfg,
                                       pos_conv_impl=args.pos_conv_impl)
    if args.feature_grad_mult != 1.0:
        xlsr_cfg = dataclasses.replace(
            xlsr_cfg, feature_grad_mult=args.feature_grad_mult)
    # the JAX CLI's pairing (occm_tpu/cli/oc_training.py:269-275)
    if args.pp > 1:
        xlsr_cfg = dataclasses.replace(
            xlsr_cfg, pp_stages=args.pp,
            pp_microbatches=args.pp_microbatches)
    if args.seq_parallel:
        xlsr_cfg = dataclasses.replace(xlsr_cfg, seq_parallel=True)
    impl = select_attention_impl(
        cut, args.attention_impl,
        min_samples=auto_flash_min_samples(xlsr_cfg, device))
    if impl != xlsr_cfg.attention_impl:
        xlsr_cfg = dataclasses.replace(xlsr_cfg, attention_impl=impl)
    return xlsr_cfg


#: --model -> the output kind its loss takes (the JAX CLI's make_model;
#: ssl_lcnn_asoftmax trains with the angle loss, reference:
#: oc_training.py:334-335)
OUTPUT_KIND_OF = {"aasist": "dual", "ssl_resnet34": "dual",
                  "ssl_lcnn": "logits", "ssl_lcnn_asoftmax": "angle",
                  "cnn": "logits", "occm": "occm"}


def make_model(name: str, xlsr_cfg):
    """(model, output kind) of `--model name`, as the JAX CLI's
    make_model."""
    from occm_tpu_torch.config import AASISTConfig
    from occm_tpu_torch.models import (
        OCCM, SSLLCNN, AModel, SSLResNet34, TotalCNNNet)

    build = {"aasist": lambda: AModel(AASISTConfig(), xlsr_cfg=xlsr_cfg),
             "ssl_resnet34": lambda: SSLResNet34(xlsr_cfg=xlsr_cfg),
             "ssl_lcnn": lambda: SSLLCNN(xlsr_cfg=xlsr_cfg),
             "ssl_lcnn_asoftmax": lambda: SSLLCNN(xlsr_cfg=xlsr_cfg,
                                                  asoftmax=True),
             "cnn": lambda: TotalCNNNet(xlsr_cfg=xlsr_cfg),
             "occm": lambda: OCCM(xlsr_cfg=xlsr_cfg)}
    if name not in build:
        raise ValueError(name)
    return build[name](), OUTPUT_KIND_OF[name]


def build_model(xlsr_cfg, seed: int, init_from=None, pretrained_xlsr=None,
                name: str = "aasist"):
    """The model of `--model name` with PyTorch's default initialisation
    drawn from a generator seeded with `seed` (the global one, forked so
    the caller's stream is untouched); then either the SSL frontend from a
    pretrained wav2vec2 / XLS-R checkpoint (`pretrained_xlsr`, which wins,
    as in the JAX CLI), or every weight from a reference-named .pt file of
    that model or an orbax directory of the JAX package (`init_from`, a
    trainer epoch directory, a converter's save or a bare parameter tree,
    its BatchNorm statistics where it has them; loaded strictly). Returns
    the model; its output kind is `make_model`'s."""
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _ = make_model(name, xlsr_cfg)
    if pretrained_xlsr:
        from occm_tpu_torch.models.convert_xlsr import graft_pretrained_xlsr

        scope = "ssl_model" if name == "aasist" else "frontend"
        graft_pretrained_xlsr(getattr(model, scope).model, pretrained_xlsr)
        print(f"Grafted pretrained XLSR {pretrained_xlsr} into '{scope}'")
    elif init_from:
        from occm_tpu_torch.models.convert_backend import (
            state_dict_from_path)

        model.load_state_dict(
            state_dict_from_path(init_from, xlsr_cfg, into=model),
            strict=True)
        print(f"Warm start from {init_from}")
    return model


def main(argv=None, on_step=None):
    """on_step(step, metrics): optional hook after every dispatch (used by
    chip_smoke.py to count kernel launches per step)."""
    args = build_parser().parse_args(argv)

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
        optimizer=args.optimizer,
        warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps,
        lr_end_ratio=args.lr_end_ratio,
    )
    from occm_tpu_torch.parallel import make_mesh
    from occm_tpu_torch.parallel import multihost
    from occm_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        # launched by torchrun: join the process group (NCCL on cards,
        # Gloo with --device cpu); the rank's device is cuda:LOCAL_RANK
        device = multihost.initialize(args.device)
    mesh = make_mesh(cfg.mesh)
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
    # the epoch shards over the mesh's DATA axes: ranks of one tp group
    # load identical data (parallel.data_shard_for_process)
    pipeline = MetaBatchPipeline(dataset, groups_per_step=cfg.groups_per_step,
                                 seed=cfg.seed, mesh=mesh)

    model = build_model(xlsr_cfg, cfg.seed, args.init_from,
                        args.pretrained_xlsr, name=args.model)

    prefix = cfg.checkpoint_prefix  # reference naming: <model>_vocoded_{e}

    def checkpoint_fn(state, epoch):
        print("Saving the models...")
        save_checkpoint(state, cfg.checkpoint_dir, prefix, epoch)

    print("Training starts...")
    return train(model, pipeline, cfg, checkpoint_fn=checkpoint_fn,
                 device=device, on_step=on_step, resume=args.resume,
                 output_kind=OUTPUT_KIND_OF[args.model], mesh=mesh,
                 debug_nans=args.debug_nans)


if __name__ == "__main__":
    main()
