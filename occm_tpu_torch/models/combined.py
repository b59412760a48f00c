"""Fused XLSR frontend + backend models (port of
`occm_tpu.models.combined`).

- SSLResNet34 (reference: models/senet.py:162-185): wave -> XLSR features
  -> SE-ResNet34 -> (com [B, 128], des [B, 2]).
- SSLLCNN (reference: models/lcnn.py:244-267): wave -> XLSR -> LCNN ->
  logits [B, 2], or with `asoftmax` the A-softmax head's (cos, psi).
- TotalCNNNet (reference: models/cnn.py:191-208): wave -> XLSR -> CNNNet.
- OCCM (reference: models/occm.py:48-67): wave -> XLSR -> (SE-ResNet34
  branch, LCNN branch) -> ((com, des), lcnn_logits).

The frontend is an `SSLModel`, so its keys are `frontend.model.*` (the
reference's fused ssl_resnet34 naming); the backends are `resnet34`,
`lcnn`, `cnn_net`, `senet34_branch` and `lcnn_branch`. The features enter
a backend as NCHW [B, 1, frames, 1024] (the reference inserts the channel
dim; the JAX package's NHWC puts it last). Each model's
`forward(x, attention_impl=None, generator=None)` is AModel's: the
attention impl overrides the config's, and in train mode the generator
draws every dropout mask, the frontend's and the backend's, on its device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models.cnn import CNNNet
from occm_tpu_torch.models.lcnn import LCNN
from occm_tpu_torch.models.senet import SEResNet
from occm_tpu_torch.models.xlsr import SSLModel, train_generator


class _SSLBackend(nn.Module):
    """An SSLModel frontend, `frontend`, under a backend."""

    def __init__(self, xlsr_cfg: Optional[XLSRConfig]):
        super().__init__()
        self.frontend = SSLModel(xlsr_cfg or XLSRConfig())

    @property
    def xlsr_cfg(self) -> XLSRConfig:
        return self.frontend.model.cfg

    def features(self, x: torch.Tensor, attention_impl: Optional[str],
                 gen: Optional[torch.Generator]) -> torch.Tensor:
        """[B, T] wave -> NCHW [B, 1, frames, dim] features."""
        return self.frontend(x, attention_impl, gen)[:, None]


class SSLResNet34(_SSLBackend):
    """reference: models/senet.py:162-185."""

    def __init__(self, xlsr_cfg: Optional[XLSRConfig] = None):
        super().__init__(xlsr_cfg)
        self.resnet34 = SEResNet(layers=(3, 4, 6, 3))

    def forward(self, x: torch.Tensor, attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        gen = train_generator(self, generator)
        return self.resnet34(self.features(x, attention_impl, gen))


class SSLLCNN(_SSLBackend):
    """reference: models/lcnn.py:244-267 (asoftmax=False by default;
    asoftmax=True gives the AngleLinear head trained with the angle loss,
    reference: oc_training.py:334-335)."""

    def __init__(self, xlsr_cfg: Optional[XLSRConfig] = None,
                 asoftmax: bool = False):
        super().__init__(xlsr_cfg)
        self.lcnn = LCNN(asoftmax=asoftmax)

    def forward(self, x: torch.Tensor, attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                eval_mode: bool = False):
        gen = train_generator(self, generator)
        return self.lcnn(self.features(x, attention_impl, gen), gen,
                         eval_mode=eval_mode)


class TotalCNNNet(_SSLBackend):
    """reference: models/cnn.py:191-208."""

    def __init__(self, xlsr_cfg: Optional[XLSRConfig] = None):
        super().__init__(xlsr_cfg)
        self.cnn_net = CNNNet()

    def forward(self, x: torch.Tensor, attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        gen = train_generator(self, generator)
        return self.cnn_net(self.features(x, attention_impl, gen), gen)


class OCCM(_SSLBackend):
    """Dual-branch OCCM (reference: models/occm.py:48-67)."""

    def __init__(self, xlsr_cfg: Optional[XLSRConfig] = None):
        super().__init__(xlsr_cfg)
        self.senet34_branch = SEResNet(layers=(3, 4, 6, 3))
        self.lcnn_branch = LCNN(asoftmax=False)

    def forward(self, x: torch.Tensor, attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        gen = train_generator(self, generator)
        feats = self.features(x, attention_impl, gen)
        return self.senet34_branch(feats), self.lcnn_branch(feats, gen)
