"""SE-ResNet34/12 dual-head backend in PyTorch (port of
`occm_tpu.models.senet`; reference: models/senet.py).

Consumes XLSR feature maps as NCHW [B, 1, frames, 1024] and returns
(com [B, 128], des [B, num_classes]): the compactness embedding and the
descriptiveness logits. Parameter names are the reference's, the naming
`occm_tpu.models.convert_backend.export_senet_state_dict` emits: `conv1`,
`bn1`, `layer{s}.{b}.{conv1, bn1, conv2, bn2, se.fc.0, se.fc.2,
downsample.0, downsample.1}`, `embedding`, `classifier`.

- SELayer: global average pool, a bias-free channel // 16 bottleneck, a
  sigmoid channel gate.
- SEBasicBlock: conv3x3-bn-relu-conv3x3-bn-SE plus the residual (a
  stride-2 1x1 conv + bn shortcut where the shape changes), relu.
- Stem: conv7x7 s2 p3 (no bias), bn, relu, maxpool3x3 s2 p1; stages of
  [3, 4, 6, 3] blocks over channels [16, 16, 32, 64, 128].
- Convs start kaiming-normal (fan_out, relu) and BatchNorm at gamma 1,
  beta 0, as in the reference. BatchNorm is `models.aasist.BatchNorm2d`:
  train mode updates the running variance from the biased batch variance,
  as Flax does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occm_tpu_torch.models.aasist import BatchNorm2d
from occm_tpu_torch.ops.pool import global_avg_pool2d, max_pool2d


class SELayer(nn.Module):
    """Squeeze-and-excitation gate (reference: models/senet.py:13-28)."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channel, channel // reduction, bias=False), nn.ReLU(),
            nn.Linear(channel // reduction, channel, bias=False),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(global_avg_pool2d(x))[:, :, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     bias=False)


class SEBasicBlock(nn.Module):
    """reference: models/senet.py:31-61."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, reduction: int = 16):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.se = SELayer(planes, reduction)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes, 1, stride), BatchNorm2d(planes)
        ) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class SEResNet(nn.Module):
    """Dual-head SE-ResNet (reference: models/senet.py:64-152): NCHW
    [B, 1, H, W] -> (com [B, 128], des [B, num_classes])."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 channels: Sequence[int] = (16, 16, 32, 64, 128),
                 num_classes: int = 2):
        super().__init__()
        self.conv1 = _conv(1, channels[0], 7, 2, 3)
        self.bn1 = BatchNorm2d(channels[0])
        inplanes = channels[0]
        for stage, (planes, blocks) in enumerate(
                zip(channels[1:], layers), start=1):
            stride = 1 if stage == 1 else 2
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != planes)
                seq.append(SEBasicBlock(inplanes, planes, s, down))
                inplanes = planes
            setattr(self, f"layer{stage}", nn.Sequential(*seq))
        self.n_stages = len(layers)
        self.embedding = nn.Linear(channels[-1], 128)
        self.classifier = nn.Linear(channels[-1], num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
        x = global_avg_pool2d(x)  # [B, 128]
        return self.embedding(x), self.classifier(x)


def se_resnet34(**kwargs) -> SEResNet:
    """reference: models/senet.py:154-156."""
    return SEResNet(layers=(3, 4, 6, 3), **kwargs)


def se_resnet12(**kwargs) -> SEResNet:
    """reference: models/senet.py:158-160."""
    return SEResNet(layers=(1, 2, 3, 1), **kwargs)
