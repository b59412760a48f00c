"""Light CNN (Max-Feature-Map) backend with an A-softmax head in PyTorch
(port of `occm_tpu.models.lcnn`; reference: models/lcnn.py).

Consumes XLSR feature maps as NCHW [B, 1, frames, 1024]; returns class
logits [B, 2], or the (cos_theta, psi_theta) pair with the A-softmax head
(`asoftmax=True`), or with `eval_mode` that head's plain cosine logits.
Parameter names are the reference's, the naming
`occm_tpu.models.convert_backend.export_lcnn_state_dict` emits:
`layer1.0.filter`, `layer{2,3}.0.conv_a.filter`, `layer{2,3}.0.conv.filter`,
`layer{2,3}.0.bn`, `layer{2,3}.2` (BatchNorm), `fc{0,1,2}.0.filter.0` and
`fc3` (a Linear, or an AngleLinear with a bias-free `weight` [in, out]).

- mfm: type 1 a conv emitting 2 * out channels, type 0 a dense layer
  emitting 2 * out features with its dropout applied *before* the max (the
  reference keeps the Dropout inside the filter Sequential).
- group: a 1x1 mfm then a kxk mfm. The reference declares a BatchNorm
  (`group.bn`) that its forward never runs; the port declares it too, so a
  reference state dict loads strictly, and never runs it (its parameters
  get no gradient).
- LCNN: channels c_s = [128, 64, 32, 16, 8, 4, 2]; layer1 mfm(1 -> 4, 5x5)
  + 2x2 max pool; layer2 group(4 -> 8) + pool + BN; layer3 group(8 -> 16) +
  pool + BN; AdaptiveAvgPool2d((1, 64)); MFM MLP 1024 -> 32 -> 32 -> 8
  (dropout 0.75, 0.75, 0); the head Linear(8, 2) or AngleLinear(8, 2).
- AngleLinear: column-normalised weight, Chebyshev cos(m theta) with
  m = 4 and theta from a detached cos theta, psi = (-1)^k cos(m theta) -
  2k; or (`phiflag=False`) the Taylor series of cos(m theta), clipped.

Dropout masks come from the generator passed to the forward (see
`models.xlsr.dropout`); `dp_out` is each dense mfm's rate.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from occm_tpu_torch.models.aasist import BatchNorm2d
from occm_tpu_torch.models.xlsr import dropout
from occm_tpu_torch.ops.mfm import mfm_max
from occm_tpu_torch.ops.pool import adaptive_avg_pool2d


class MFMConv(nn.Module):
    """mfm type 1 (reference: models/lcnn.py:123-127, 133-136)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.out_channels = out_channels
        self.filter = nn.Conv2d(in_channels, 2 * out_channels, kernel_size,
                                stride=stride, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mfm_max(self.filter(x), self.out_channels, dim=1)


class MFMDense(nn.Module):
    """mfm type 0: dense, dropout, then the feature-halving max
    (reference: models/lcnn.py:128-131)."""

    def __init__(self, in_features: int, out_features: int,
                 dp_out: float = 0.75):
        super().__init__()
        self.out_features = out_features
        self.dp_out = dp_out
        self.filter = nn.Sequential(nn.Linear(in_features, 2 * out_features))

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.filter(x), self.dp_out, gen)
        return mfm_max(x, self.out_features)


class MFMGroup(nn.Module):
    """group = 1x1 mfm then kxk mfm (reference: models/lcnn.py:139-149);
    `bn` is declared and never run."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int, padding: int):
        super().__init__()
        self.conv_a = MFMConv(in_channels, in_channels, 1, 1, 0)
        self.bn = BatchNorm2d(in_channels)
        self.conv = MFMConv(in_channels, out_channels, kernel_size, stride,
                            padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.conv_a(x))


class AngleLinear(nn.Module):
    """SphereFace angular-margin head (reference: models/lcnn.py:23-83)."""

    def __init__(self, in_features: int, out_features: int, m: int = 4,
                 phiflag: bool = True):
        super().__init__()
        self.m = m
        self.phiflag = phiflag
        # weight.uniform_(-1, 1) (reference: models/lcnn.py:29)
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features).uniform_(-1.0, 1.0))

    def forward(self, x: torch.Tensor, eval_mode: bool = False):
        w = self.weight
        # renorm(2, 1, 1e-5).mul(1e5): columns with norm > 1e-5 become unit
        col_norm = torch.linalg.vector_norm(w, dim=0, keepdim=True)
        ww = torch.where(col_norm > 1e-5, w / torch.clamp(col_norm, min=1e-20),
                         w * 1e5)
        wlen = torch.linalg.vector_norm(ww, dim=0)  # ~1
        if eval_mode:
            # forward_eval (reference: models/lcnn.py:69-83)
            return (x @ ww) / wlen[None, :]

        xlen = torch.linalg.vector_norm(x, dim=1)
        cos_theta = (x @ ww) / xlen[:, None] / wlen[None, :]
        cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
        if self.phiflag:
            # mlambda[4], Chebyshev (reference: models/lcnn.py:32-39)
            c = cos_theta
            cos_m_theta = 8 * c ** 4 - 8 * c ** 2 + 1
            # theta is detached (Variable(cos_theta.data).acos())
            theta = torch.arccos(cos_theta.detach())
            k = torch.floor(self.m * theta / 3.14159265)
            sign = 1.0 - 2.0 * torch.remainder(k, 2.0)  # (-1)^k, k >= 0
            psi_theta = sign * cos_m_theta - 2.0 * k
        else:
            x_m = torch.arccos(cos_theta) * self.m
            psi_theta = (
                1 - x_m ** 2 / math.factorial(2) + x_m ** 4 / math.factorial(4)
                - x_m ** 6 / math.factorial(6) + x_m ** 8 / math.factorial(8)
                - x_m ** 9 / math.factorial(9))
            psi_theta = torch.clamp(psi_theta, -1.0 * self.m, 1.0)
        return cos_theta * xlen[:, None], psi_theta * xlen[:, None]


class LCNN(nn.Module):
    """reference: models/lcnn.py:151-217. NCHW input [B, 1, H, W]."""

    def __init__(self, c_s: Tuple[int, ...] = (128, 64, 32, 16, 8, 4, 2),
                 asoftmax: bool = True, phiflag: bool = True,
                 num_classes: int = 2, desired_width: int = 64):
        super().__init__()
        c = c_s
        self.asoftmax = asoftmax
        self.desired_width = desired_width
        self.layer1 = nn.Sequential(MFMConv(1, c[5], 5, 1, 2),
                                    nn.MaxPool2d(2))
        self.layer2 = nn.Sequential(MFMGroup(c[5], c[4], 3, 1, 1),
                                    nn.MaxPool2d(2), BatchNorm2d(c[4]))
        self.layer3 = nn.Sequential(MFMGroup(c[4], c[3], 3, 1, 1),
                                    nn.MaxPool2d(2), BatchNorm2d(c[3]))
        self.fc0 = nn.Sequential(MFMDense(c[3] * desired_width, 32, 0.75))
        self.fc1 = nn.Sequential(MFMDense(32, 32, 0.75))
        self.fc2 = nn.Sequential(MFMDense(32, 8, 0.0))
        self.fc3 = (AngleLinear(8, num_classes, phiflag=phiflag) if asoftmax
                    else nn.Linear(8, num_classes))
        # reference init_weight (models/lcnn.py:219-229)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                        nonlinearity="relu")
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.xavier_normal_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                eval_mode: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """gen: the dropout generator in train mode (None in eval mode)."""
        x = self.layer3(self.layer2(self.layer1(x)))
        x = adaptive_avg_pool2d(x, (1, self.desired_width))
        x = x.flatten(1)  # NCHW [B, C, 1, W] -> [B, C * W]
        for fc in (self.fc0, self.fc1, self.fc2):
            x = fc[0](x, gen)
        if self.asoftmax:
            return self.fc3(x, eval_mode=eval_mode)
        return self.fc3(x)


def lcnn_net(**kwargs) -> LCNN:
    """reference: models/lcnn.py:239-241."""
    return LCNN(**kwargs)
