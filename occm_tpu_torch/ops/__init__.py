from occm_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
    reference_attention,
)
from occm_tpu_torch.ops.pool import max_pool2d
from occm_tpu_torch.ops.pos_conv import pos_conv_grouped

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_reference",
    "reference_attention",
    "max_pool2d",
    "pos_conv_grouped",
]
