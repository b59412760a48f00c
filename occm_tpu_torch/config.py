"""Configuration for the PyTorch port.

A copy of `occm_tpu.config`'s `RawBoostConfig`, `XLSRConfig`,
`AASISTConfig`, `MeshConfig` and `TrainConfig`: the same fields, defaults,
`tiny()` presets and validation, so a configuration means the same model
and the same training run in both packages. Fields that select a code path
the port does not implement yet raise `NotImplementedError` when set to a
non-default value, rather than being silently ignored. The training fields
of the models (dropout rates, layerdrop, remat, conv_remat,
feature_grad_mult) act in train mode (`model.train()`); eval mode, which
serving runs, applies no dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RawBoostConfig:
    """RawBoost augmentation hyper-parameters (reference defaults).
    algo: 0 none, 1 LnL, 2 ISD, 3 SSI, 4 (1+2+3), 5 (1+2), 6 (1+3),
    7 (2+3), 8 (1||2). Only algo 0 is ported: the trainer raises on any
    other (ROADMAP queue A)."""

    algo: int = 3
    nBands: int = 5
    minF: int = 20
    maxF: int = 8000
    minBW: int = 100
    maxBW: int = 1000
    minCoeff: int = 10
    maxCoeff: int = 100
    minG: int = 0
    maxG: int = 0
    minBiasLinNonLin: int = 5
    maxBiasLinNonLin: int = 20
    N_f: int = 5
    P: int = 10
    g_sd: int = 2
    SNRmin: int = 10
    SNRmax: int = 40
    fs: int = 16000


@dataclasses.dataclass(frozen=True)
class XLSRConfig:
    """wav2vec2 / XLSR architecture; defaults are XLS-R 300M: 7-layer conv
    feature encoder with overall stride 320, 24 pre-norm transformer layers,
    d_model 1024, 16 heads, FFN 4096, conv positional embedding."""

    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    extractor_mode: str = "layer_norm"
    encoder_layers: int = 24
    encoder_embed_dim: int = 1024
    encoder_ffn_dim: int = 4096
    encoder_heads: int = 16
    conv_pos: int = 128
    conv_pos_groups: int = 16
    pos_conv_impl: str = "grouped"
    layer_norm_first: bool = True
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    dropout_input: float = 0.0
    out_dim: int = 1024
    remat: bool = True
    dtype: str = "bfloat16"          # compute dtype of the matmuls and convs
    # "xla": plain torch attention (fp32 logits and softmax); "flash": the
    # hand-written CUDA flash-attention kernels (ops/attention.py)
    attention_impl: str = "xla"
    feature_grad_mult: float = 1.0
    norm_dtype: str = "float32"      # LayerNorm / softmax dtype
    scan_unroll: int = 1
    remat_policy: str = "nothing"
    gelu_approximate: bool = False
    conv_gelu_approximate: bool = False
    layerdrop: float = 0.0
    # the port keeps fp32 parameters and casts each weight to `dtype` where
    # it is used, which gives the same numbers as a one-off bf16 mirror
    bf16_param_mirror: bool = False
    fused_qkv: bool = False
    # "xla": fc1, GELU and fc2 as three calls; "pallas": ops/ffn.fused_ffn,
    # the hand-written CUDA fused FFN forward (the hidden activation stays on
    # chip), with JAX's recompute backward. Same parameters either way.
    ffn_impl: str = "xla"
    # "pallas": the transformer LayerNorms run ops/layernorm.fast_layer_norm
    # (output in the input dtype, the CUDA LayerNorm backward kernel)
    ln_impl: str = "xla"
    quant_int8: bool = False
    pp_stages: int = 1
    pp_microbatches: int = 0
    seq_parallel: bool = False
    conv_remat: bool = False
    allow_debug_impls: bool = False

    def __post_init__(self):
        if self.seq_parallel and self.pp_stages > 1:
            raise ValueError(
                "seq_parallel is not composable with pp_stages > 1")
        impl = self.attention_impl
        packed_ok = impl.startswith("packed") and (
            impl == "packed" or impl[len("packed"):].isdigit())
        if impl not in ("xla", "xla_merged", "pad128", "flash",
                        "skip") and not packed_ok:
            raise ValueError(
                f"unknown attention_impl {impl!r} (xla | xla_merged | "
                "packed[N] | pad128 | flash | skip)")
        if impl == "skip" and not self.allow_debug_impls:
            raise ValueError(
                'attention_impl="skip" passes V through untouched (perf '
                "attribution only, NOT attention); set "
                "allow_debug_impls=True to use it in an A/B harness")
        for field, value, valid in (
            ("pos_conv_impl", self.pos_conv_impl,
             ("grouped", "batched", "s2d")),
            ("ffn_impl", self.ffn_impl, ("xla", "pallas")),
            ("ln_impl", self.ln_impl, ("xla", "pallas")),
            ("extractor_mode", self.extractor_mode,
             ("layer_norm", "default")),
            ("dtype", self.dtype, ("bfloat16", "float32")),
            ("norm_dtype", self.norm_dtype, ("bfloat16", "float32")),
            ("remat_policy", self.remat_policy,
             ("nothing", "dots", "attn_out", "attn_out_inner",
              "attn_probs", "attn_all")),
        ):
            if value not in valid:
                raise ValueError(
                    f"unknown {field} {value!r} ({' | '.join(valid)})")
        unported = [
            ("pp_stages", self.pp_stages != 1),
            ("seq_parallel", self.seq_parallel),
            ("quant_int8", self.quant_int8),
            ("remat_policy", self.remat_policy != "nothing"),
            ("fused_qkv", self.fused_qkv),
            ("attention_impl", impl not in ("xla", "flash")),
            ("pos_conv_impl", self.pos_conv_impl != "grouped"),
            ("extractor_mode", self.extractor_mode != "layer_norm"),
        ]
        for field, set_ in unported:
            if set_:
                raise NotImplementedError(
                    f"XLSRConfig.{field}={getattr(self, field)!r} is not "
                    "ported to occm_tpu_torch yet")

    @staticmethod
    def tiny() -> "XLSRConfig":
        """Small config for CPU tests."""
        return XLSRConfig(
            conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
            encoder_layers=2,
            encoder_embed_dim=64,
            encoder_ffn_dim=128,
            encoder_heads=4,
            conv_pos=16,
            conv_pos_groups=4,
            out_dim=64,
            remat=False,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class AASISTConfig:
    """AASIST graph-attention backend hyper-parameters."""

    filts: Tuple = (128, (1, 32), (32, 32), (32, 64), (64, 64))
    gat_dims: Tuple[int, int] = (64, 32)
    pool_ratios: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 0.5)
    temperatures: Tuple[float, float, float, float] = (2.0, 2.0, 100.0, 100.0)
    pos_s_nodes: int = 42
    ll_dim: int = 128
    dropout: float = 0.2
    pool_dropout: float = 0.3
    head_dropout: float = 0.5

    @staticmethod
    def tiny() -> "AASISTConfig":
        """Small config for CPU tests; pos_s_nodes must stay ll_dim // 3."""
        return AASISTConfig(
            filts=(24, (1, 8), (8, 8), (8, 16), (16, 16)),
            gat_dims=(16, 8),
            pos_s_nodes=8,
            ll_dim=24,
        )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. The port trains on one GPU: dp must be -1 (all
    devices, here one) or 1, and the other axes 1; anything else raises
    (multi-GPU is ROADMAP queue A)."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1

    def __post_init__(self):
        if self.dp not in (-1, 1) or (self.fsdp, self.tp, self.pp) != (
                1, 1, 1):
            raise NotImplementedError(
                f"MeshConfig{dataclasses.astuple(self)}: the port trains on "
                "one GPU (dp -1 or 1, fsdp = tp = pp = 1); multi-GPU is not "
                "ported yet (ROADMAP queue A: multi-GPU)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters, the JAX package's fields and defaults.
    Not ported yet, and raising: wandb_project; the trainer raises on
    rawboost.algo != 0."""

    model: str = "aasist"
    optimizer: str = "adam"        # "adam" (torch.optim.Adam) | "fused_adam"
    lr: float = 1e-5
    num_epochs: int = 100
    compactness_weight: float = 0.0
    descriptiveness_weight: float = 1.0
    seed: int = 0
    cut: int = 64600
    meta_batch: int = 12
    groups_per_step: int = 1
    steps_per_dispatch: int = 1
    rawboost: RawBoostConfig = dataclasses.field(
        default_factory=RawBoostConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    checkpoint_dir: str = "."
    checkpoint_prefix: str = "aasist_vocoded"
    log_every: int = 100
    loss_txt: str = "loss.txt"
    wandb_project: Optional[str] = None
    checkpoint_every_steps: int = 0
    grad_accum: int = 1
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    lr_end_ratio: float = 0.0

    def __post_init__(self):
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        if self.groups_per_step % self.grad_accum:
            raise ValueError(
                f"groups_per_step ({self.groups_per_step}) must be divisible "
                f"by grad_accum ({self.grad_accum}): every micro-batch holds "
                "whole meta-batches so the per-group compactness term is "
                "computable")
        if self.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r} "
                             "(constant | cosine | linear)")
        if self.lr_schedule != "constant":
            if self.decay_steps <= 0:
                raise ValueError(
                    f"lr_schedule={self.lr_schedule!r} needs decay_steps > 0")
            if self.optimizer != "adam":
                raise ValueError(
                    "lr schedules require optimizer='adam' (fused_adam "
                    "takes a fixed scalar lr)")
        if self.optimizer not in ("adam", "fused_adam"):
            raise ValueError(f"unknown optimizer {self.optimizer!r} "
                             "(adam | fused_adam)")
        if self.wandb_project is not None:
            raise NotImplementedError(
                f"TrainConfig.wandb_project={self.wandb_project!r} is not "
                "ported to occm_tpu_torch yet (ROADMAP queue A: remaining "
                "features)")
