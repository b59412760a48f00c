"""XLSR wav2vec2 encoder in PyTorch (port of `occm_tpu.models.xlsr`).

Parameter names follow fairseq's wav2vec2 state dict (the naming
`occm_tpu.models.convert_backend.export_xlsr_state_dict` emits), so a
reference checkpoint loads with `load_state_dict(strict=True)`:

  feature_extractor.conv_layers.{i}.0      Conv1d
  feature_extractor.conv_layers.{i}.2.1    LayerNorm over channels
  layer_norm, post_extract_proj
  encoder.pos_conv.0.{weight_g,weight_v,bias}   weight-normed grouped conv
  encoder.layers.{l}.self_attn.{q,k,v,out}_proj
  encoder.layers.{l}.{self_attn_layer_norm,fc1,fc2,final_layer_norm}
  encoder.layer_norm

Numerics follow the JAX package: parameters stay fp32 and each matmul or
conv weight is cast to `cfg.dtype` (bf16) where it is used; LayerNorm
statistics and the softmax run at `cfg.norm_dtype` (fp32). With
`ln_impl="pallas"` the transformer LayerNorms run `fast_layer_norm`
(fp32 statistics, output in the input dtype, CUDA backward kernel).

Train mode (`model.train()`) applies every fairseq dropout site the JAX
package has: attention probabilities (`attention_dropout`, plain attention
only: the flash kernels never materialise them, so a non-zero rate raises
there, as in JAX), the two residual branches and the encoder input
(`dropout`), the FFN activation (`activation_dropout`), the projected
features (`dropout_input`), and `layerdrop` (a dropped layer is skipped).
`remat` recomputes each transformer layer in the backward
(`torch.utils.checkpoint`, non-reentrant), `conv_remat` the conv feature
extractor, and `feature_grad_mult` scales the gradient into the extractor
(0 detaches it). Dropout masks come from an explicit CPU
`torch.Generator` passed to the forward: each site draws a seed from it
and its mask from a device generator seeded with that; each transformer
layer re-seeds its sites from a per-layer seed, so a remat recompute
reproduces the forward's masks. Eval mode applies no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.ops.attention import flash_attention
from occm_tpu_torch.ops.layernorm import fast_layer_norm
from occm_tpu_torch.ops.pos_conv import pos_conv_grouped

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _linear(x: torch.Tensor, layer: nn.Linear, dt) -> torch.Tensor:
    """nn.Dense(dtype=dt): input, kernel and bias cast to dt."""
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, ndt) -> torch.Tensor:
    """nn.LayerNorm(dtype=ndt): statistics and output at ndt."""
    return F.layer_norm(x.to(ndt), ln.normalized_shape, ln.weight.to(ndt),
                        ln.bias.to(ndt), ln.eps)


def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def draw_seed(gen: torch.Generator) -> int:
    """A 62-bit seed from a CPU generator (no device sync)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


def dropout(x: torch.Tensor, p: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout`: keep each element with probability 1 - p and
    scale it by 1 / (1 - p); the identity when `gen` is None (eval mode)
    or p is 0. The mask comes from a device generator seeded from `gen`."""
    if gen is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    dev_gen = torch.Generator(device=x.device).manual_seed(draw_seed(gen))
    keep = torch.rand(x.shape, generator=dev_gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def train_generator(module: nn.Module,
                    gen: Optional[torch.Generator]
                    ) -> Optional[torch.Generator]:
    """The dropout generator of a forward: None in eval mode; in train mode
    `gen`, or one seeded from torch's global generator when none is
    given."""
    if not module.training:
        return None
    if gen is not None:
        return gen
    return torch.Generator().manual_seed(
        int(torch.randint(0, 2 ** 62, (1,))))


class _GradMultiply(torch.autograd.Function):
    """fairseq GradMultiply: identity forward, gradient times `mult`."""

    @staticmethod
    def forward(ctx, x, mult: float):
        ctx.mult = mult
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.mult, None


def grad_multiply(x: torch.Tensor, mult: float) -> torch.Tensor:
    return _GradMultiply.apply(x, mult)


class ConvFeatureExtractor(nn.Module):
    """wav2vec2 conv subsampler in layer_norm extractor mode: [B, T] wave ->
    [B, frames, conv_dim] in the compute dtype."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        in_dim = 1
        for dim, k, s in cfg.conv_layers:
            layers.append(nn.ModuleDict({
                "0": nn.Conv1d(in_dim, dim, k, stride=s, bias=True),
                "2": nn.ModuleDict({"1": nn.LayerNorm(dim, eps=1e-5)}),
            }))
            in_dim = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _DTYPES[self.cfg.dtype]
        ndt = _DTYPES[self.cfg.norm_dtype]
        h = x[:, None, :].to(dt)                            # [B, 1, T]
        for layer in self.conv_layers:
            conv = layer["0"]
            h = F.conv1d(h, conv.weight.to(dt), conv.bias.to(dt),
                         stride=conv.stride)
            # LayerNorm over channels: torch convs are NCW
            h = _layer_norm(h.transpose(1, 2), layer["2"]["1"], ndt)
            h = _gelu(h.to(dt), self.cfg.conv_gelu_approximate)
            h = h.transpose(1, 2)
        return h.transpose(1, 2)                            # [B, F, C]


class PosConv(nn.Module):
    """Relative positional conv embedding: grouped conv (k=128, groups=16)
    with fairseq's weight norm over the kernel axis. The weight is folded,
    w = g * v / ||v|| with the norm over axes (0, 1) of v [C, C/G, K], in
    fp32 on every call, then cast to the compute dtype."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        c, k, g = cfg.encoder_embed_dim, cfg.conv_pos, cfg.conv_pos_groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, k))
        self.weight_v = nn.Parameter(torch.empty(c, c // g, k))
        self.bias = nn.Parameter(torch.zeros(c))
        nn.init.normal_(self.weight_v, std=math.sqrt(1.0 / (k * c // g)))

    def weight(self) -> torch.Tensor:
        v = self.weight_v.float()
        norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
        return self.weight_g.float() * v / torch.clamp(norm, min=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] -> [B, T + 1 - K % 2, C] (uncropped)."""
        dt = _DTYPES[self.cfg.dtype]
        out = pos_conv_grouped(x.transpose(1, 2).to(dt), self.weight().to(dt),
                               self.cfg.conv_pos_groups)
        return out.transpose(1, 2) + self.bias.to(dt)


class SelfAttention(nn.Module):
    """Multi-head self-attention: bf16 projections, fp32 softmax."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, impl: str,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = _DTYPES[cfg.dtype]
        ndt = _DTYPES[cfg.norm_dtype]
        d, h = cfg.encoder_embed_dim, cfg.encoder_heads
        hd = d // h
        B, T, _ = x.shape
        q = _linear(x, self.q_proj, dt).reshape(B, T, h, hd)
        k = _linear(x, self.k_proj, dt).reshape(B, T, h, hd)
        v = _linear(x, self.v_proj, dt).reshape(B, T, h, hd)
        if impl == "flash":
            if gen is not None and cfg.attention_dropout > 0.0:
                raise ValueError(
                    'attention_impl="flash" cannot apply attention_dropout '
                    "(the probabilities never materialise); train with "
                    'attention_impl="xla" or zero the rate')
            out = flash_attention(q, k, v).to(dt)
        elif impl == "xla":
            q = q * (hd ** -0.5)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ndt), k.to(ndt))
            probs = dropout(torch.softmax(logits, dim=-1).to(dt),
                            cfg.attention_dropout, gen)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        else:
            raise NotImplementedError(
                f"attention_impl={impl!r} is not ported (xla | flash)")
        return _linear(out.reshape(B, T, d), self.out_proj, dt)


class TransformerLayer(nn.Module):
    """Pre-/post-norm transformer block (fairseq
    TransformerSentenceEncoderLayer)."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.encoder_embed_dim, cfg.encoder_ffn_dim
        self.self_attn = SelfAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, f)
        self.fc2 = nn.Linear(f, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def _norm(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.ln_impl == "pallas":
            return fast_layer_norm(x, ln.weight, ln.bias, ln.eps)
        return _layer_norm(x, ln, _DTYPES[self.cfg.norm_dtype])

    def forward(self, x: torch.Tensor, impl: str,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = _DTYPES[cfg.dtype]
        pre = cfg.layer_norm_first

        residual = x
        h = self._norm(self.self_attn_layer_norm, x) if pre else x
        h = dropout(self.self_attn(h, impl, gen), cfg.dropout, gen)
        x = residual + h
        if not pre:
            x = self._norm(self.self_attn_layer_norm, x).to(dt)

        residual = x
        h = self._norm(self.final_layer_norm, x) if pre else x
        h = _gelu(_linear(h, self.fc1, dt), cfg.gelu_approximate)
        h = dropout(h, cfg.activation_dropout, gen)
        h = dropout(_linear(h, self.fc2, dt), cfg.dropout, gen)
        x = residual + h
        if not pre:
            x = self._norm(self.final_layer_norm, x).to(dt)
        return x


class TransformerEncoder(nn.Module):
    """Holds the positional conv, the layer stack and the encoder LayerNorm
    under fairseq's `encoder.*` names; XLSREncoder runs them."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.pos_conv = nn.ModuleList([PosConv(cfg)])
        self.layers = nn.ModuleList(
            [TransformerLayer(cfg) for _ in range(cfg.encoder_layers)])
        self.layer_norm = nn.LayerNorm(cfg.encoder_embed_dim, eps=1e-5)


class XLSREncoder(nn.Module):
    """Raw wave [B, T] -> contextual features [B, frames, out_dim] fp32
    (the reference's `SSLModel.extract_feat`)."""

    def __init__(self, cfg: XLSRConfig = XLSRConfig()):
        super().__init__()
        self.cfg = cfg
        conv_dim = cfg.conv_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.layer_norm = nn.LayerNorm(conv_dim, eps=1e-5)
        if conv_dim != cfg.encoder_embed_dim:
            self.post_extract_proj = nn.Linear(conv_dim, cfg.encoder_embed_dim)
        else:
            self.post_extract_proj = None
        self.encoder = TransformerEncoder(cfg)

    def forward(self, x: torch.Tensor,
                attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """attention_impl overrides cfg.attention_impl ("xla" | "flash"),
        so one set of weights serves buckets that pick different impls.
        generator: the CPU generator of the dropout masks in train mode."""
        cfg = self.cfg
        impl = attention_impl or cfg.attention_impl
        dt = _DTYPES[cfg.dtype]
        gen = train_generator(self, generator)
        remat = self.training and torch.is_grad_enabled()
        if x.dim() == 3:  # the reference squeezes a trailing channel dim
            x = x[:, :, 0]
        if cfg.conv_remat and remat:
            feats = checkpoint(self.feature_extractor, x, use_reentrant=False)
        else:
            feats = self.feature_extractor(x)
        # fairseq GradMultiply: scale (or stop) the gradient into the convs
        if cfg.feature_grad_mult == 0.0:
            feats = feats.detach()
        elif cfg.feature_grad_mult != 1.0:
            feats = grad_multiply(feats, cfg.feature_grad_mult)
        feats = _layer_norm(feats, self.layer_norm, torch.float32).to(dt)
        if self.post_extract_proj is not None:
            feats = _linear(feats, self.post_extract_proj, dt)
        feats = dropout(feats, cfg.dropout_input, gen)

        pos = self.encoder.pos_conv[0](feats)[:, : feats.shape[1], :]
        x = feats + _gelu(pos, cfg.conv_gelu_approximate)
        if not cfg.layer_norm_first:
            x = _layer_norm(x, self.encoder.layer_norm, torch.float32).to(dt)
        x = dropout(x, cfg.dropout, gen)
        layer_dropout = max(cfg.dropout, cfg.attention_dropout,
                            cfg.activation_dropout) > 0.0
        for layer in self.encoder.layers:
            if gen is not None and cfg.layerdrop > 0.0 and bool(
                    torch.rand((), generator=gen) < cfg.layerdrop):
                continue  # fairseq encoder_layerdrop: the layer is skipped
            seed = draw_seed(gen) if gen is not None and layer_dropout \
                else None
            if cfg.remat and remat:
                x = checkpoint(_run_layer, layer, x, impl, seed,
                               use_reentrant=False)
            else:
                x = _run_layer(layer, x, impl, seed)
        if cfg.layer_norm_first:
            x = _layer_norm(x, self.encoder.layer_norm, torch.float32)
        return x.float()


def _run_layer(layer: TransformerLayer, x: torch.Tensor, impl: str,
               seed: Optional[int]) -> torch.Tensor:
    """One transformer layer whose dropout sites draw from a generator
    seeded with `seed` (None: no dropout), so a remat recompute draws the
    forward's masks, and remat on or off gives the same masks."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return layer(x, impl, gen)


class SSLModel(nn.Module):
    """The reference's SSLModel wrapper: parameters under `model.*`."""

    def __init__(self, cfg: XLSRConfig = XLSRConfig()):
        super().__init__()
        self.model = XLSREncoder(cfg)

    def forward(self, x: torch.Tensor,
                attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(x, attention_impl, generator)
