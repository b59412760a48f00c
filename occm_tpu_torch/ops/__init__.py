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
from occm_tpu_torch.ops.pool import max_pool2d
from occm_tpu_torch.ops.pos_conv import pos_conv_grouped


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since its last reset, by kernel
    (the wrappers count in Python, so a CUDA graph's replays do not
    tick them: its launches are the counts its capture added)."""
    from occm_tpu_torch.ops import attention, ffn, fused_adam, layernorm

    return {"flash_attn_fwd": attention.LAUNCHES,
            "flash_attn_bwd_dq": attention.BWD_DQ_LAUNCHES,
            "flash_attn_bwd_dkv": attention.BWD_DKV_LAUNCHES,
            "layernorm_bwd": layernorm.LAUNCHES,
            "fused_adam": fused_adam.LAUNCHES,
            "ffn_fwd": ffn.LAUNCHES}


__all__ = [
    "FusedAdam",
    "adam_reference",
    "fast_layer_norm",
    "ffn_fwd",
    "ffn_reference",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_reference",
    "fused_ffn",
    "launch_counts",
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "max_pool2d",
    "pos_conv_grouped",
    "reference_attention",
]
