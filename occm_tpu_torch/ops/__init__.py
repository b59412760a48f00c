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
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "max_pool2d",
    "pos_conv_grouped",
    "reference_attention",
]
