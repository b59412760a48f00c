from occm_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
    reference_attention,
)
from occm_tpu_torch.ops.ffn import ffn_fwd, ffn_reference, fused_ffn
from occm_tpu_torch.ops.fused_adam import FusedAdam, adam_reference
from occm_tpu_torch.ops.layernorm import (
    fast_layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
)
from occm_tpu_torch.ops.mfm import mfm_max
from occm_tpu_torch.ops.pool import (
    adaptive_avg_pool2d,
    avg_pool2d,
    global_avg_pool2d,
    max_pool2d,
)
from occm_tpu_torch.ops.pos_conv import pos_conv_grouped


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since its last reset, by kernel
    (the wrappers count in Python, so a CUDA graph's replays do not
    tick them: its launches are the counts its capture added)."""
    from occm_tpu_torch.ops import attention, ffn, fused_adam, layernorm

    return {"flash_attn_fwd": attention.LAUNCHES,
            "flash_attn_bwd_dq": attention.BWD_DQ_LAUNCHES,
            "flash_attn_bwd_dkv": attention.BWD_DKV_LAUNCHES,
            "flash_attn_fwd_other_d": attention.OTHER_D_LAUNCHES,
            "flash_attn_fwd_panel": attention.PANEL_LAUNCHES,
            "flash_attn_bwd_panel_dq": attention.PANEL_BWD_DQ_LAUNCHES,
            "flash_attn_bwd_panel_dkv": attention.PANEL_BWD_DKV_LAUNCHES,
            "flash_attn_bwd_other_d_dq": attention.OTHER_D_BWD_DQ_LAUNCHES,
            "flash_attn_bwd_other_d_dkv": attention.OTHER_D_BWD_DKV_LAUNCHES,
            "layernorm_bwd": layernorm.LAUNCHES,
            "fused_adam": fused_adam.LAUNCHES,
            "ffn_fwd": ffn.LAUNCHES,
            "flash_attn_generic_fwd": attention.GENERIC_LAUNCHES,
            "flash_attn_generic_bwd_dq": attention.GENERIC_BWD_DQ_LAUNCHES,
            "flash_attn_generic_bwd_dkv": attention.GENERIC_BWD_DKV_LAUNCHES,
            "flash_attn_3xtf32_fwd": attention.TF32_FWD_LAUNCHES,
            "flash_attn_3xtf32_bwd_dq": attention.TF32_BWD_DQ_LAUNCHES,
            "flash_attn_3xtf32_bwd_dkv": attention.TF32_BWD_DKV_LAUNCHES,
            "ffn_fwd_f32": ffn.F32_LAUNCHES,
            "ffn_fwd_3xtf32": ffn.TF32_LAUNCHES}


__all__ = [
    "FusedAdam",
    "adaptive_avg_pool2d",
    "adam_reference",
    "avg_pool2d",
    "fast_layer_norm",
    "ffn_fwd",
    "ffn_reference",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_reference",
    "fused_ffn",
    "global_avg_pool2d",
    "launch_counts",
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "max_pool2d",
    "mfm_max",
    "pos_conv_grouped",
    "reference_attention",
]
