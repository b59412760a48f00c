"""The wav2vec2 relative positional conv (k=128, groups=16) in PyTorch.

Port of `occm_tpu.ops.pos_conv.pos_conv_grouped`. The port keeps torch's
own layouts: activations [B, C, T] and the weight [C, C/G, K] (fairseq's
`encoder.pos_conv.0` layout). SamePad cropping (fairseq drops the trailing
output for even K) is done by the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pos_conv_grouped(x: torch.Tensor, w: torch.Tensor, groups: int,
                     bias: torch.Tensor = None) -> torch.Tensor:
    """[B, C, T] x [C, C/G, K] -> [B, C, T + 1 - K % 2] grouped conv with
    K // 2 zero padding on both sides."""
    return F.conv1d(x, w, bias, padding=w.shape[-1] // 2, groups=groups)
