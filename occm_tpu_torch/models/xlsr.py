"""XLSR wav2vec2 encoder in PyTorch (port of `occm_tpu.models.xlsr`).

Parameter names follow fairseq's wav2vec2 state dict (the naming
`occm_tpu.models.convert_backend.export_xlsr_state_dict` emits), so a
reference checkpoint loads with `load_state_dict(strict=True)`:

  feature_extractor.conv_layers.{i}.0      Conv1d
  feature_extractor.conv_layers.{i}.2.1    LayerNorm over channels
  layer_norm, post_extract_proj
  encoder.pos_conv.0.{weight_g,weight_v,bias}   weight-normed grouped conv
                                                (trained as one folded kernel)
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
features (`dropout_input`), and `layerdrop`. With `ffn_impl="pallas"` the
FFN runs `fused_ffn` (the CUDA fused forward), which cannot apply
`activation_dropout`: train mode with a non-zero rate raises, as in JAX.
`remat` recomputes each transformer layer in the backward
(`torch.utils.checkpoint`, non-reentrant), `conv_remat` the conv feature
extractor, and `feature_grad_mult` scales the gradient into the extractor
(0 detaches it).

Dropout masks are drawn from an explicit `torch.Generator` passed to the
forward, on the device it lives on: on a card, a CUDA generator whose
Philox state advances on the device, so a CUDA graph of the step (see
`train.graph`) draws fresh masks on every replay. A transformer layer's
masks are drawn before the layer runs and handed to it, so a remat
recompute reuses them (the recompute draws nothing, and checkpoint need not
restore any generator). Under remat the masks of every layer are therefore
held until the backward: bool tensors of the sites' shapes, none at the
default rates of 0. Layerdrop draws its keep flag on the device too; a
dropped layer still runs and is discarded with `where(keep, y, x)`, as the
JAX package does (its parameters then get a zero gradient). Eval mode
applies no dropout.

The positional conv trains one folded kernel `weight` [C, C/G, K], as the
JAX package does. Its state dict is fairseq's weight-norm pair: saving
writes v = w and g = ||w|| (the JAX exporter's split), and loading folds
w = v * (g / ||v||) (`fold_weight_norm`), so a reference checkpoint loads
strictly and a saved one loads into fairseq's layout.
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
from occm_tpu_torch.ops.ffn import fused_ffn
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


def dropout_keep(shape, p: float, gen: torch.Generator,
                 device) -> torch.Tensor:
    """The keep mask of a dropout site: True with probability 1 - p, drawn
    from `gen` on its own device and placed on `device`."""
    keep = torch.rand(shape, generator=gen, device=gen.device) >= p
    return keep.to(device)


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor],
               p: float) -> torch.Tensor:
    """x where `keep`, scaled by 1 / (1 - p), and 0 elsewhere; x itself
    when there is no mask."""
    if keep is None:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def dropout(x: torch.Tensor, p: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout`: keep each element with probability 1 - p and
    scale it by 1 / (1 - p); the identity when `gen` is None (eval mode)
    or p is 0."""
    if gen is None or p == 0.0:
        return x
    return apply_keep(x, dropout_keep(x.shape, p, gen, x.device), p)


def train_generator(module: nn.Module,
                    gen: Optional[torch.Generator]
                    ) -> Optional[torch.Generator]:
    """The dropout generator of a forward: None in eval mode; in train mode
    `gen`, or one on the module's device seeded from torch's global
    generator when none is given."""
    if not module.training:
        return None
    if gen is not None:
        return gen
    device = next(module.parameters()).device
    return torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2 ** 62, (1,))))


def fold_weight_norm(weight_g: torch.Tensor,
                     weight_v: torch.Tensor) -> torch.Tensor:
    """fairseq's weight norm over the kernel axis (the port's copy of
    `occm_tpu.models.convert_xlsr.fold_weight_norm`, dim=2): w = g * v /
    ||v|| with the norm over axes (0, 1) of v [C, C/G, K], computed as
    v * (g / ||v||), so a pair saved as (||w||, w) folds back to w bit for
    bit."""
    v = weight_v.float()
    return v * (weight_g.float() / torch.clamp(weight_norm_g(v), min=1e-12))


def weight_norm_g(w: torch.Tensor) -> torch.Tensor:
    """g = ||w|| over axes (0, 1), summed in fp64 and rounded to fp32, so
    that sums of w in another order (on another device) round to the same
    g."""
    return torch.sqrt(torch.sum(w.double() ** 2, dim=(0, 1),
                                keepdim=True)).float()


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
    """Relative positional conv embedding: grouped conv (k=128, groups=16),
    trained as one folded kernel `weight` [C, C/G, K] (fp32, cast to the
    compute dtype where it is used). Its state dict holds fairseq's
    `weight_g` / `weight_v` instead (see the module docstring)."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        c, k, g = cfg.encoder_embed_dim, cfg.conv_pos, cfg.conv_pos_groups
        self.weight = nn.Parameter(torch.empty(c, c // g, k))
        self.bias = nn.Parameter(torch.zeros(c))
        # fairseq initialises v this way and g = ||v||, so w = v
        nn.init.normal_(self.weight, std=math.sqrt(1.0 / (k * c // g)))
        self.register_state_dict_post_hook(PosConv._to_weight_norm)
        self.register_load_state_dict_pre_hook(PosConv._fold)

    @staticmethod
    def _to_weight_norm(module, state, prefix, local_metadata):
        w = state.pop(prefix + "weight")
        state[prefix + "weight_g"] = weight_norm_g(w).to(w.dtype)
        state[prefix + "weight_v"] = w
        state.move_to_end(prefix + "bias")

    def _fold(self, state, prefix, local_metadata, strict, missing_keys,
              unexpected_keys, error_msgs):
        if prefix + "weight_v" in state:
            g = state.pop(prefix + "weight_g", None)
            v = state.pop(prefix + "weight_v")
            if g is None:
                missing_keys.append(prefix + "weight_g")
                return
            state[prefix + "weight"] = fold_weight_norm(g, v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] -> [B, T + 1 - K % 2, C] (uncropped)."""
        dt = _DTYPES[self.cfg.dtype]
        out = pos_conv_grouped(x.transpose(1, 2).to(dt), self.weight.to(dt),
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
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """keep: the attention-probability dropout mask [B, H, T, T] (plain
        attention only), or None."""
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
            out = flash_attention(q, k, v).to(dt)
        elif impl == "xla":
            q = q * (hd ** -0.5)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ndt), k.to(ndt))
            probs = apply_keep(torch.softmax(logits, dim=-1).to(dt), keep,
                               cfg.attention_dropout)
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

    def draw_masks(self, x: torch.Tensor, impl: str,
                   gen: Optional[torch.Generator]):
        """The layer's dropout masks for input x [B, T, D], in the order its
        sites run: attention probabilities, the attention branch, the FFN
        activation, the FFN branch (None where a site's rate is 0 or there
        is no generator)."""
        cfg = self.cfg
        if gen is None:
            return (None,) * 4
        if impl == "flash" and cfg.attention_dropout > 0.0:
            raise ValueError(
                'attention_impl="flash" cannot apply attention_dropout '
                "(the probabilities never materialise); train with "
                'attention_impl="xla" or zero the rate')
        if cfg.activation_dropout > 0.0 and cfg.ffn_impl == "pallas":
            raise ValueError(
                "activation_dropout needs the hidden FFN activation "
                'materialised: train with ffn_impl="xla", or zero the rate')
        B, T, d = x.shape
        shapes = ((B, cfg.encoder_heads, T, T), (B, T, d),
                  (B, T, cfg.encoder_ffn_dim), (B, T, d))
        rates = (cfg.attention_dropout, cfg.dropout, cfg.activation_dropout,
                 cfg.dropout)
        return tuple(dropout_keep(shape, p, gen, x.device) if p > 0.0
                     else None for shape, p in zip(shapes, rates))

    def forward(self, x: torch.Tensor, impl: str,
                masks=(None, None, None, None)) -> torch.Tensor:
        """masks: `draw_masks`' tuple (all None: no dropout)."""
        cfg = self.cfg
        dt = _DTYPES[cfg.dtype]
        pre = cfg.layer_norm_first
        keep_attn, keep_res1, keep_act, keep_res2 = masks

        residual = x
        h = self._norm(self.self_attn_layer_norm, x) if pre else x
        h = apply_keep(self.self_attn(h, impl, keep_attn), keep_res1,
                       cfg.dropout)
        x = residual + h
        if not pre:
            x = self._norm(self.self_attn_layer_norm, x).to(dt)

        residual = x
        h = self._norm(self.final_layer_norm, x) if pre else x
        if cfg.ffn_impl == "pallas":
            # fused fc1 + GELU + fc2 (ops/ffn.py): the weights in the compute
            # dtype, fc1/fc2 in nn.Linear's layout, passed as W1 = fc1.weight^T
            # and W2 = fc2.weight^T (views; the kernel reads them untransposed)
            h = fused_ffn(h.to(dt), self.fc1.weight.to(dt).t(),
                          self.fc1.bias.to(dt), self.fc2.weight.to(dt).t(),
                          self.fc2.bias.to(dt), cfg.gelu_approximate)
        else:
            h = _gelu(_linear(h, self.fc1, dt), cfg.gelu_approximate)
            h = apply_keep(h, keep_act, cfg.activation_dropout)
            h = _linear(h, self.fc2, dt)
        h = apply_keep(h, keep_res2, cfg.dropout)
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
        generator: the generator of the dropout masks in train mode."""
        cfg = self.cfg
        impl = attention_impl or cfg.attention_impl
        dt = _DTYPES[cfg.dtype]
        gen = train_generator(self, generator)
        remat = self.training and torch.is_grad_enabled()
        if x.dim() == 3:  # the reference squeezes a trailing channel dim
            x = x[:, :, 0]
        if cfg.conv_remat and remat:
            feats = checkpoint(self.feature_extractor, x, use_reentrant=False,
                               preserve_rng_state=False)
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
        for layer in self.encoder.layers:
            keep = None
            if gen is not None and cfg.layerdrop > 0.0:
                # fairseq encoder_layerdrop: drop the layer with probability
                # p; the flag is drawn on the generator's device
                keep = (torch.rand((), generator=gen, device=gen.device)
                        >= cfg.layerdrop).to(x.device)
            masks = layer.draw_masks(x, impl, gen)
            if cfg.remat and remat:
                # the masks are inputs, so the recompute draws nothing
                y = checkpoint(layer, x, impl, masks, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                y = layer(x, impl, masks)
            # the layer always runs and a dropped one is discarded on the
            # device, as the JAX package's where(keep, y, carry)
            x = y if keep is None else torch.where(keep, y, x)
        if cfg.layer_norm_first:
            x = _layer_norm(x, self.encoder.layer_norm, torch.float32)
        return x.float()


class SSLModel(nn.Module):
    """The reference's SSLModel wrapper: parameters under `model.*`."""

    def __init__(self, cfg: XLSRConfig = XLSRConfig()):
        super().__init__()
        self.model = XLSREncoder(cfg)

    def forward(self, x: torch.Tensor,
                attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(x, attention_impl, generator)
