"""AASIST spectro-temporal graph-attention backend in PyTorch (port of
`occm_tpu.models.aasist`).

Layout is torch's NCHW: the RawNet2 encoder sees [B, C, spectral=42,
temporal]. Graph tensors are [B, nodes, dim]. Parameter names are the
reference's (models/sslassist.py), the naming
`occm_tpu.models.convert_backend.export_amodel_state_dict` emits. In eval
mode BatchNorm layers use their running statistics and no dropout runs. In
train mode (`model.train()`) BatchNorm normalises with batch statistics and
updates its running statistics as Flax does: momentum 0.1 (Flax's 0.9) and
the biased batch variance (`BatchNorm1d`, `BatchNorm2d` below; torch's own
layers keep the unbiased one). The JAX package's dropout sites apply: the GAT and HtrgGAT inputs
(`cfg.dropout`), the graph pools' score input only (`pool_dropout`), the
six way-fusion tensors (`cfg.dropout`) and the head input
(`head_dropout`; `emb` is returned before it). Masks come from the CPU
generator passed to the forward (see `models.xlsr.dropout`).
Reference quirks kept, as in the JAX
package: the residual block convolves the raw input (its bn1 pre-activation
is computed and discarded by the reference, so bn1 is declared for the
checkpoint and never run), and the HtrgGAT layers take the raw [1, 1, D]
master parameters.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.models.xlsr import SSLModel, dropout, train_generator
from occm_tpu_torch.ops.pool import max_pool2d


class _FlaxStats:
    """Train mode: torch's batch-statistics normalisation, with the running
    statistics updated from the biased batch variance, as
    `flax.linen.BatchNorm` updates them; eval mode as torch. The state dict
    is torch's (weight, bias, running_mean, running_var,
    num_batches_tracked)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


def _bn_feat(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm1d over every leading axis, per trailing feature."""
    return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class GraphAttentionLayer(nn.Module):
    """reference: models/sslassist.py:58-151."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float = 1.0,
                 dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.att_proj = nn.Linear(in_dim, out_dim)
        self.att_weight = nn.Parameter(torch.empty(out_dim, 1))
        self.proj_with_att = nn.Linear(in_dim, out_dim)
        self.proj_without_att = nn.Linear(in_dim, out_dim)
        self.bn = BatchNorm1d(out_dim)
        self.temperature = temperature
        nn.init.xavier_normal_(self.att_weight)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(x, self.dropout, gen)
        pair = x[:, :, None, :] * x[:, None, :, :]          # [B,N,N,D]
        att = torch.tanh(self.att_proj(pair)) @ self.att_weight
        att = torch.softmax(att / self.temperature, dim=-2)
        x1 = self.proj_with_att(torch.einsum("bij,bjd->bid", att[..., 0], x))
        x = x1 + self.proj_without_att(x)
        return F.selu(_bn_feat(self.bn, x))


class HtrgGraphAttentionLayer(nn.Module):
    """Heterogeneous GAT with a master node
    (reference: models/sslassist.py:154-329)."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float = 1.0,
                 dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.proj_type1 = nn.Linear(in_dim, in_dim)
        self.proj_type2 = nn.Linear(in_dim, in_dim)
        self.att_proj = nn.Linear(in_dim, out_dim)
        self.att_projM = nn.Linear(in_dim, out_dim)
        self.att_weight11 = nn.Parameter(torch.empty(out_dim, 1))
        self.att_weight22 = nn.Parameter(torch.empty(out_dim, 1))
        self.att_weight12 = nn.Parameter(torch.empty(out_dim, 1))
        self.att_weightM = nn.Parameter(torch.empty(out_dim, 1))
        self.proj_with_att = nn.Linear(in_dim, out_dim)
        self.proj_without_att = nn.Linear(in_dim, out_dim)
        self.proj_with_attM = nn.Linear(in_dim, out_dim)
        self.proj_without_attM = nn.Linear(in_dim, out_dim)
        self.bn = BatchNorm1d(out_dim)
        self.temperature = temperature
        for w in (self.att_weight11, self.att_weight22, self.att_weight12,
                  self.att_weightM):
            nn.init.xavier_normal_(w)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                master: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None):
        n1 = x1.shape[1]
        x = torch.cat([self.proj_type1(x1), self.proj_type2(x2)], dim=1)
        if master is None:
            master = x.mean(dim=1, keepdim=True)
        x = dropout(x, self.dropout, gen)

        pair = x[:, :, None, :] * x[:, None, :, :]          # [B,N,N,D]
        att = torch.tanh(self.att_proj(pair))
        a11 = att[:, :n1, :n1] @ self.att_weight11
        a12 = att[:, :n1, n1:] @ self.att_weight12
        a21 = att[:, n1:, :n1] @ self.att_weight12
        a22 = att[:, n1:, n1:] @ self.att_weight22
        board = torch.cat([torch.cat([a11, a12], dim=2),
                           torch.cat([a21, a22], dim=2)], dim=1)
        att_map = torch.softmax(board / self.temperature, dim=-2)

        attm = torch.tanh(self.att_projM(x * master)) @ self.att_weightM
        attm = torch.softmax(attm / self.temperature, dim=-2)
        m1 = self.proj_with_attM(
            torch.einsum("bn,bnd->bd", attm[..., 0], x)[:, None, :])
        master = m1 + self.proj_without_attM(master)

        h = self.proj_with_att(torch.einsum("bij,bjd->bid", att_map[..., 0], x))
        h = F.selu(_bn_feat(self.bn, h + self.proj_without_att(x)))
        return h[:, :n1], h[:, n1:], master


class GraphPool(nn.Module):
    """Top-k node pooling (reference: models/sslassist.py:332-368): nodes
    kept in descending score order."""

    def __init__(self, k: float, in_dim: int, p: float = 0.0):
        super().__init__()
        self.k = k
        self.p = p
        self.proj = nn.Linear(in_dim, 1)

    def forward(self, h: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        # dropout on the score input only; the kept nodes are h * scores
        scores = torch.sigmoid(self.proj(dropout(h, self.p, gen)))  # [B,N,1]
        n_keep = max(int(h.shape[1] * self.k), 1)
        # a stable descending sort breaks ties (sigmoid saturates to exactly
        # 1.0 on large inputs) towards the lower node index, as
        # jax.lax.top_k does; torch.topk leaves the order of ties open
        idx = torch.sort(scores[..., 0], dim=1, descending=True,
                         stable=True).indices[:, :n_keep]
        idx = idx[..., None].expand(-1, -1, h.shape[-1])
        return torch.gather(h * scores, 1, idx)


class ResidualBlock(nn.Module):
    """RawNet2-style residual conv block (reference:
    models/sslassist.py:373-429), NCHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 first: bool = False):
        super().__init__()
        if not first:  # declared by the reference, output discarded
            self.bn1 = BatchNorm2d(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, (2, 3),
                               padding=(1, 1))
        self.bn2 = BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, (2, 3),
                               padding=(0, 1))
        if in_channels != out_channels:
            self.conv_downsample = nn.Conv2d(in_channels, out_channels,
                                             (1, 3), padding=(0, 1))
        else:
            self.conv_downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.selu(self.bn2(self.conv1(x))))
        identity = x if self.conv_downsample is None else \
            self.conv_downsample(x)
        return out + identity


class AASISTBackend(nn.Module):
    """AASIST over SSL features [B, frames, ssl_dim] -> (emb [B, 5*gat1],
    logits [B, 2]). Its parameters sit at the top level of AModel's state
    dict, so AModel inherits from it."""

    def __init__(self, cfg: AASISTConfig = AASISTConfig(),
                 ssl_dim: int = 1024):
        super().__init__()
        self.aasist_cfg = cfg
        gat0, gat1 = cfg.gat_dims
        t0, t1, t2, _t3 = cfg.temperatures
        chans = [f[1] if isinstance(f, (tuple, list)) else f
                 for f in cfg.filts[1:]]
        ins = [1, chans[0], chans[1], chans[2], chans[3], chans[3]]
        outs = [chans[0], chans[1], chans[2], chans[3], chans[3], chans[3]]

        self.LL = nn.Linear(ssl_dim, cfg.ll_dim)
        self.first_bn = BatchNorm2d(1)
        self.first_bn1 = BatchNorm2d(outs[-1])
        self.encoder = nn.Sequential(*[
            nn.Sequential(ResidualBlock(i, o, first=(n == 0)))
            for n, (i, o) in enumerate(zip(ins, outs))])
        self.attention = nn.Sequential(
            nn.Conv2d(outs[-1], cfg.ll_dim, 1), nn.SELU(),
            BatchNorm2d(cfg.ll_dim), nn.Conv2d(cfg.ll_dim, outs[-1], 1))
        self.pos_S = nn.Parameter(torch.randn(1, cfg.pos_s_nodes, outs[-1]))
        self.master1 = nn.Parameter(torch.randn(1, 1, gat0))
        self.master2 = nn.Parameter(torch.randn(1, 1, gat0))
        dp = cfg.dropout
        self.GAT_layer_S = GraphAttentionLayer(outs[-1], gat0, t0, dp)
        self.GAT_layer_T = GraphAttentionLayer(outs[-1], gat0, t1, dp)
        self.HtrgGAT_layer_ST11 = HtrgGraphAttentionLayer(gat0, gat1, t2, dp)
        self.HtrgGAT_layer_ST12 = HtrgGraphAttentionLayer(gat1, gat1, t2, dp)
        self.HtrgGAT_layer_ST21 = HtrgGraphAttentionLayer(gat0, gat1, t2, dp)
        self.HtrgGAT_layer_ST22 = HtrgGraphAttentionLayer(gat1, gat1, t2, dp)
        r, pp = cfg.pool_ratios, cfg.pool_dropout
        self.pool_S = GraphPool(r[0], gat0, pp)
        self.pool_T = GraphPool(r[1], gat0, pp)
        self.pool_hS1 = GraphPool(r[2], gat1, pp)
        self.pool_hT1 = GraphPool(r[3], gat1, pp)
        self.pool_hS2 = GraphPool(r[2], gat1, pp)
        self.pool_hT2 = GraphPool(r[3], gat1, pp)
        self.out_layer = nn.Linear(5 * gat1, 2)

    def backend(self, x_ssl: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.aasist_cfg
        gen = train_generator(self, generator)
        x = self.LL(x_ssl)                                  # [B,F,ll]
        x = max_pool2d(x.transpose(1, 2)[:, None], (3, 3))  # [B,1,42,F//3]
        x = F.selu(self.first_bn(x))
        x = self.encoder(x)
        x = F.selu(self.first_bn1(x))                       # [B,C,42,F']
        w = self.attention(x)

        # spectral branch: softmax over the temporal axis
        e_S = torch.sum(x * torch.softmax(w, dim=3), dim=3).transpose(1, 2)
        out_S = self.pool_S(self.GAT_layer_S(e_S + self.pos_S, gen), gen)
        # temporal branch: softmax over the spectral axis
        e_T = torch.sum(x * torch.softmax(w, dim=2), dim=2).transpose(1, 2)
        out_T = self.pool_T(self.GAT_layer_T(e_T, gen), gen)

        def inference(ht1, ht2, pool_s, pool_t, master):
            o_T, o_S, m = ht1(out_T, out_S, master=master, gen=gen)
            o_S = pool_s(o_S, gen)
            o_T = pool_t(o_T, gen)
            o_T_aug, o_S_aug, m_aug = ht2(o_T, o_S, master=m, gen=gen)
            return o_T + o_T_aug, o_S + o_S_aug, m + m_aug

        out_T1, out_S1, m1 = inference(
            self.HtrgGAT_layer_ST11, self.HtrgGAT_layer_ST12,
            self.pool_hS1, self.pool_hT1, self.master1)
        out_T2, out_S2, m2 = inference(
            self.HtrgGAT_layer_ST21, self.HtrgGAT_layer_ST22,
            self.pool_hS2, self.pool_hT2, self.master2)

        # way-fusion dropout: six independent masks
        out_T1, out_T2, out_S1, out_S2, m1, m2 = (
            dropout(t, cfg.dropout, gen)
            for t in (out_T1, out_T2, out_S1, out_S2, m1, m2))
        out_T = torch.maximum(out_T1, out_T2)
        out_S = torch.maximum(out_S1, out_S2)
        master = torch.maximum(m1, m2)
        emb = torch.cat([out_T.abs().amax(dim=1), out_T.mean(dim=1),
                         out_S.abs().amax(dim=1), out_S.mean(dim=1),
                         master[:, 0, :]], dim=1)
        return emb, self.out_layer(dropout(emb, cfg.head_dropout, gen))

    forward = backend


class AModel(AASISTBackend):
    """Full XLSR + AASIST model (reference: models/sslassist.py:432-597):
    raw wave [B, T] -> (emb [B, 160], logits [B, 2])."""

    def __init__(self, cfg: AASISTConfig = AASISTConfig(),
                 xlsr_cfg: Optional[XLSRConfig] = None):
        xlsr_cfg = xlsr_cfg or XLSRConfig()
        super().__init__(cfg, ssl_dim=xlsr_cfg.encoder_embed_dim)
        self.ssl_model = SSLModel(xlsr_cfg)

    @property
    def xlsr_cfg(self) -> XLSRConfig:
        return self.ssl_model.model.cfg

    def forward(self, x: torch.Tensor, attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """generator: the CPU generator of the dropout masks in train mode
        (one from torch's global generator when None)."""
        gen = train_generator(self, generator)
        return self.backend(self.ssl_model(x, attention_impl, gen), gen)
