"""Plain CNN feature-map backends in PyTorch (port of
`occm_tpu.models.cnn`; reference: models/cnn.py).

Four small classifiers over XLSR feature maps, NCHW [B, C, frames, feat],
returning logits [B, 2]. Parameter names are the Flax scopes': `conv1`,
`bn1`, ..., `fc1`..`fc3`, `attention1.conv`, `attention3.conv`. The JAX
package transposes its NHWC maps to NCHW before it flattens, so its dense
weights are in torch's channel-major order; the port flattens NCHW
directly.

- CNNNet (cnn_net): conv(1 -> 8 -> 16 -> 32, k3 p1), each ReLU'd then
  BatchNorm'd, 2x2 max pools after the first two, adaptive average pool to
  (1, 256), then an 8192 -> 128 -> 64 -> 2 MLP with dropout 0.5 after fc1.
- CNNNetBasic: no BatchNorm, two convs, adaptive width 4096, no dropout.
- CNNNetComplex: a 2-channel input, widths 4 / 8 / 16.
- CNNNetWithAttention: SpatialAttention (a 1x1 conv to one channel, a
  sigmoid gate) after conv1's BN and after conv3's BN.

BatchNorm is `models.aasist.BatchNorm2d` (running variance from the biased
batch variance, as Flax). The dropout mask comes from the generator passed
to the forward; `dropout_rate` is its rate.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from occm_tpu_torch.models.aasist import BatchNorm2d
from occm_tpu_torch.models.xlsr import dropout
from occm_tpu_torch.ops.pool import adaptive_avg_pool2d, max_pool2d


class SpatialAttention(nn.Module):
    """1x1-conv sigmoid spatial gate (reference: models/cnn.py:5-18)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(x))


class _ConvMLP(nn.Module):
    """Three 3x3 convs (each ReLU'd, then BatchNorm'd when `bn`), 2x2 max
    pools after the first two, an optional spatial gate after the first
    and third, the adaptive pool and the MLP head."""

    def __init__(self, widths, desired_width: int, in_channels: int = 1,
                 bn: bool = True, attention: bool = False,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.desired_width = desired_width
        self.dropout_rate = dropout_rate
        self.n_convs = len(widths)
        cin = in_channels
        for i, w in enumerate(widths, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, w, 3, padding=1))
            if bn:
                setattr(self, f"bn{i}", BatchNorm2d(w))
            cin = w
        if attention:
            self.attention1 = SpatialAttention(widths[0])
            self.attention3 = SpatialAttention(widths[2])
        self.fc1 = nn.Linear(widths[-1] * desired_width, 128)
        self.fc2 = nn.Linear(128, 64)
        self.fc3 = nn.Linear(64, 2)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """gen: the dropout generator in train mode (None in eval mode)."""
        for i in range(1, self.n_convs + 1):
            x = F.relu(getattr(self, f"conv{i}")(x))
            bn = getattr(self, f"bn{i}", None)
            if bn is not None:
                x = bn(x)
            gate = getattr(self, f"attention{i}", None)
            if gate is not None:
                x = gate(x)
            if i < 3:
                x = max_pool2d(x, 2)
        x = adaptive_avg_pool2d(x, (1, self.desired_width)).flatten(1)
        x = dropout(F.relu(self.fc1(x)), self.dropout_rate, gen)
        return self.fc3(F.relu(self.fc2(x)))


class CNNNet(_ConvMLP):
    """cnn_net (reference: models/cnn.py:149-189)."""

    def __init__(self, desired_width: int = 256):
        super().__init__((8, 16, 32), desired_width)


class CNNNetBasic(_ConvMLP):
    """cnn_net_basic (reference: models/cnn.py:117-148)."""

    def __init__(self, desired_width: int = 4096):
        super().__init__((8, 16), desired_width, bn=False, dropout_rate=0.0)


class CNNNetComplex(_ConvMLP):
    """cnn_net_complex, 2-channel input (reference: models/cnn.py:69-116)."""

    def __init__(self, desired_width: int = 256):
        super().__init__((4, 8, 16), desired_width, in_channels=2)


class CNNNetWithAttention(_ConvMLP):
    """cnn_net_with_attention (reference: models/cnn.py:20-66)."""

    def __init__(self, desired_width: int = 256):
        super().__init__((8, 16, 32), desired_width, attention=True)
