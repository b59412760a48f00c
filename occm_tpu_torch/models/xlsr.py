"""XLSR wav2vec2 encoder in PyTorch (port of `occm_tpu.models.xlsr`).

Parameter names follow fairseq's wav2vec2 state dict (the naming
`occm_tpu.models.convert_backend.export_xlsr_state_dict` emits), so a
reference checkpoint loads with `load_state_dict(strict=True)`:

  feature_extractor.conv_layers.{i}.0      Conv1d
  feature_extractor.conv_layers.{i}.2.1    LayerNorm over channels
                                           (extractor_mode "layer_norm")
  feature_extractor.conv_layers.0.2        GroupNorm, block 0 only
                                           (extractor_mode "default")
  layer_norm, post_extract_proj
  encoder.pos_conv.0.{weight_g,weight_v,bias}   weight-normed grouped conv
                                                (trained as one folded kernel)
  encoder.layers.{l}.self_attn.{q,k,v,out}_proj
  encoder.layers.{l}.{self_attn_layer_norm,fc1,fc2,final_layer_norm}
  encoder.layer_norm

Numerics follow the JAX package: parameters stay fp32 and each matmul or
conv weight is cast to `cfg.dtype` (bf16) where it is used; LayerNorm
statistics and the softmax run at `cfg.norm_dtype` (fp32). With
`bf16_param_mirror` every fp32 parameter of the transformer stack
(LayerNorms included) is cast to bf16 once per forward, before the layer
loop, and the layers read only those copies, as JAX's `nn.map_variables`
mirror does; the extractor, positional conv and encoder LayerNorm keep
fp32. With `ln_impl="pallas"` the transformer LayerNorms run
`fast_layer_norm` (fp32 statistics, output in the input dtype, CUDA
backward kernel). With `quant_int8` the six projections of every layer
are `Int8Linear`s ({weight_q int8, scale, bias}, `ops/int8.py`'s W8A8
product), each returning its input's dtype as JAX's `Int8Dense` does; the
int8 FFN is taken before `ffn_impl`.

Attention layouts (`attention_impl`): "flash" runs the CUDA kernels;
"xla", "xla_merged", "pad128" and "packed[N]" are the JAX package's
layouts of the plain math (`_plain_attention`: the same logits, softmax
dtype, dropout site and remat names, the products laid out differently);
"skip" passes V through (timing attribution only). `fused_qkv` makes q,
k and v in one product over the three weights concatenated where they
are used, so the parameters and the state dict are the same either way.
The positional conv runs in the layout `pos_conv_impl` names
(`ops/pos_conv.py`: grouped, batched, s2d) on the same folded weight.

Train mode (`model.train()`) applies every fairseq dropout site the JAX
package has: attention probabilities (`attention_dropout`, plain attention
only: the flash kernels never materialise them, so a non-zero rate raises
there, as in JAX), the two residual branches and the encoder input
(`dropout`), the FFN activation (`activation_dropout`), the projected
features (`dropout_input`), and `layerdrop`. With `ffn_impl="pallas"` the
FFN runs `fused_ffn` (the CUDA fused forward), which cannot apply
`activation_dropout`: train mode with a non-zero rate raises, as in JAX.
`remat` recomputes each transformer layer in the backward
(`torch.utils.checkpoint`, non-reentrant), except the tensors that
`remat_policy` keeps (`models/remat.py`: the layer names the ops that make
them, as JAX's `checkpoint_name` does); `conv_remat` recomputes the conv
feature extractor, and `feature_grad_mult` scales the gradient into the
extractor (0 detaches it).

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

Tensor parallelism (a `parallel.compute_mesh` with tp > 1): each rank holds
its shards of the layers' projections (`parallel/sharding.py`: q/k/v and
fc1 rows, out_proj and fc2 columns) and computes Megatron's split on them:
its H/tp heads (flash or plain attention on [B, T, H/tp, D]) and its F/tp
FFN columns; the row-parallel out_proj / fc2 partial products are summed
over the tp group and their biases added once, after the sum (the fused
FFN kernel gets a zero fc2 bias). The inputs of the column-parallel
products pass Megatron's f (identity forward, all-reduce backward) and
the sums are its g. Dropout masks are drawn whole and sliced to the
rank's heads / columns. The int8 projections have no split: an int8 row
quantised over a column shard is another function.

Sequence parallelism (`seq_parallel` under tp > 1, Megatron-SP): the
stack's input is cut to this rank's block of the frames (T padded to a
multiple of tp with zero frames), and each layer's residual path (its
LayerNorms, dropouts and residual adds) runs on that block. Before
attention and before the FFN the frames are all-gathered (and the pad
sliced off); the row-parallel out_proj and fc2 reduce-scatter over the
frames instead of all-reducing (the pad put back first; the bias added
once, after), and the stack's output is gathered whole again. The pad
frames get no gradient. The residual-branch masks are drawn whole and
the rank keeps its frames; Megatron's f is not needed (the gather's
backward reduces).

The GPipe pipeline (`pp_stages` S > 1, `pp_microbatches` M, 0 meaning
S): in one process the stack runs the M microbatches of the batch in
turn and concatenates them, the same function as the sequential stack
(JAX's unsharded schedule). On a mesh whose pp = P divides S
(`pp_group`), each rank's encoder runs its S / P consecutive stages of
the schedule's forward (JAX's stage axis sharded over pp): their layers
on the microbatches, tick by tick, received from the rank before, handed
from stage to stage on the rank, and sent to the rank after; rank 0 runs
the frontend, the last rank the head and returns the features. It
leaves what the backward needs in `stage_pass`, which `train.loop` takes
to run the microbatches' backward in reverse tick order.
Dropout masks and layerdrop flags of every layer are drawn for the whole
batch, in layer order, before the first layer runs (`draw_layers`), so
the pipelined and the sequential stacks draw alike; a microbatch takes
its rows of them.

The positional conv trains one folded kernel `weight` [C, C/G, K], as the
JAX package does. Its state dict is fairseq's weight-norm pair: saving
writes v = w and g = ||w|| (the JAX exporter's split), and loading folds
w = v * (g / ||v||) (`fold_weight_norm`), so a reference checkpoint loads
strictly and a saved one loads into fairseq's layout.
"""

from __future__ import annotations

import dataclasses
import math
from operator import attrgetter
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models import remat
from occm_tpu_torch.ops.attention import flash_attention
from occm_tpu_torch.ops.ffn import fused_ffn
from occm_tpu_torch.ops.int8 import int8_matmul
from occm_tpu_torch.ops.layernorm import fast_layer_norm
from occm_tpu_torch.ops.pos_conv import POS_CONV_IMPLS
from occm_tpu_torch.parallel.collectives import (
    copy_to, gather_frames, gather_rows, recv, reduce_from, scatter_frames,
    send, split_frames)
from occm_tpu_torch.parallel.mesh import (
    batch_shard, current_mesh, pp_group, pp_peer, tp_group)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _linear(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], dt,
            tag: Optional[str] = None) -> torch.Tensor:
    """nn.Dense(dtype=dt): input, kernel and bias cast to dt (no-ops where
    they are dt already, as under the bf16 mirror); the product is named
    `tag` for the remat policies. bias None: the product alone (a
    row-parallel shard's partial sum under tp)."""
    x, weight = x.to(dt), weight.to(dt)
    bias = None if bias is None else bias.to(dt)
    with remat.name(tag):
        return F.linear(x, weight, bias)


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                ndt, eps: float = 1e-5) -> torch.Tensor:
    """nn.LayerNorm(dtype=ndt): statistics and output at ndt."""
    return F.layer_norm(x.to(ndt), weight.shape, weight.to(ndt),
                        bias.to(ndt), eps)


def _ln(x: torch.Tensor, ln: nn.LayerNorm, ndt) -> torch.Tensor:
    return _layer_norm(x, ln.weight, ln.bias, ndt, ln.eps)


def _params_of(module: nn.Module, names) -> dict:
    """module's parameters by name, read through attribute access, so what
    stands in for them (torch.func.functional_call) is what is read."""
    return {n: attrgetter(n)(module) for n in names}


def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _sp(cfg: XLSRConfig):
    """The tp group tuple (group, size, index) when the layers run
    sequence parallelism, else None."""
    tp = tp_group()
    return tp if cfg.seq_parallel and tp is not None else None


def _padded(frames: int, n: int) -> int:
    return -(-frames // n) * n


def _pad_frames(t: torch.Tensor, frames: int) -> torch.Tensor:
    """t [B, T, ...] with zero frames appended up to `frames`."""
    extra = frames - t.shape[1]
    if extra == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], extra) + t.shape[2:])], 1)


def _frame_block(t: torch.Tensor, sp) -> torch.Tensor:
    """This rank's block of t's frames (dim 1, padded to a multiple of the
    tp size with zero frames)."""
    return split_frames(_pad_frames(t, _padded(t.shape[1], sp[1])), sp[0])


def dropout_keep(shape, p: float, gen: torch.Generator,
                 device) -> torch.Tensor:
    """The keep mask of a dropout site: True with probability 1 - p, drawn
    from `gen` on its own device and placed on `device`. Inside a train
    step whose batch is split over ranks (`parallel.mesh.sharded_batch`),
    the mask is drawn for the global batch (dim 0 times the shard count)
    and this rank's rows are taken, so every rank draws what one process
    draws for the whole batch and the generators stay in step."""
    shard = batch_shard()
    if shard is not None and shard.count > 1 and len(shape) > 0:
        rows = shape[0]
        full = (rows * shard.count,) + tuple(shape[1:])
        keep = torch.rand(full, generator=gen, device=gen.device) >= p
        keep = keep[shard.index * rows:(shard.index + 1) * rows]
    else:
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
    """wav2vec2 conv subsampler: [B, T] wave -> [B, frames, conv_dim] in the
    compute dtype. extractor_mode "layer_norm" normalises every block over
    its channels (`conv_layers.{i}.2.1`); "default" has one GroupNorm with a
    group per channel after block 0 (`conv_layers.0.2`), computed in fp32
    and cast back to the compute dtype, and no norm in the other blocks.
    A state dict without a conv's bias (a checkpoint with conv_bias=False,
    such as wav2vec2-base's) loads strictly, with zeros for it, as the JAX
    converter fills them."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        in_dim = 1
        for i, (dim, k, s) in enumerate(cfg.conv_layers):
            layer = {"0": nn.Conv1d(in_dim, dim, k, stride=s, bias=True)}
            if cfg.extractor_mode == "layer_norm":
                layer["2"] = nn.ModuleDict({"1": nn.LayerNorm(dim, eps=1e-5)})
            elif i == 0:
                layer["2"] = nn.GroupNorm(dim, dim, eps=1e-5)
            layers.append(nn.ModuleDict(layer))
            in_dim = dim
        self.conv_layers = nn.ModuleList(layers)
        self.register_load_state_dict_pre_hook(
            ConvFeatureExtractor._zero_missing_biases)

    def _zero_missing_biases(self, state, prefix, local_metadata, strict,
                             missing_keys, unexpected_keys, error_msgs):
        for i in range(len(self.conv_layers)):
            key = f"{prefix}conv_layers.{i}.0."
            if key + "weight" in state and key + "bias" not in state:
                w = state[key + "weight"]
                state[key + "bias"] = torch.zeros(w.shape[0], dtype=w.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _DTYPES[self.cfg.dtype]
        ndt = _DTYPES[self.cfg.norm_dtype]
        h = x[:, None, :].to(dt)                            # [B, 1, T]
        for layer in self.conv_layers:
            conv = layer["0"]
            h = F.conv1d(h, conv.weight.to(dt), conv.bias.to(dt),
                         stride=conv.stride)
            norm = layer["2"] if "2" in layer else None
            if isinstance(norm, nn.GroupNorm):
                h = F.group_norm(h.float(), norm.num_groups,
                                 norm.weight.float(), norm.bias.float(),
                                 norm.eps).to(dt)
            elif norm is not None:
                # LayerNorm over channels: torch convs are NCW
                h = _ln(h.transpose(1, 2), norm["1"], ndt).transpose(1, 2)
            h = _gelu(h.to(dt), self.cfg.conv_gelu_approximate)
        return h.transpose(1, 2)                            # [B, F, C]


class PosConv(nn.Module):
    """Relative positional conv embedding: grouped conv (k=128, groups=16)
    in the layout cfg.pos_conv_impl names (ops/pos_conv.py), trained as
    one folded kernel `weight` [C, C/G, K] (fp32, cast to the
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
        """[B, T, C] -> [B, T', C] (uncropped: T' = T + 1 - K % 2, or T
        under "s2d"), in the layout of cfg.pos_conv_impl."""
        dt = _DTYPES[self.cfg.dtype]
        conv = POS_CONV_IMPLS[self.cfg.pos_conv_impl]
        out = conv(x.transpose(1, 2).to(dt), self.weight.to(dt),
                   self.cfg.conv_pos_groups)
        return out.transpose(1, 2) + self.bias.to(dt)


class Int8Linear(nn.Module):
    """A projection in the `quant_int8` layout (the JAX package's
    `Int8Dense`): `weight_q` int8 [out, in] (nn.Linear's layout, frozen),
    `scale` fp32 [out] and `bias` fp32 [out], all parameters, so the bf16
    mirror rounds scale and bias and leaves weight_q, as JAX's does.
    Written by `ops.int8.quantize_state_dict_int8` from a trained fp32
    state dict. The layers apply it with `_int8_linear` on their (possibly
    mirrored) parameters, in the input's dtype."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_q = nn.Parameter(
            torch.zeros(out_features, in_features, dtype=torch.int8),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))


def _projection(cfg: XLSRConfig, d_in: int, d_out: int) -> nn.Module:
    return Int8Linear(d_in, d_out) if cfg.quant_int8 else nn.Linear(d_in,
                                                                    d_out)


def _int8_linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """Int8Linear `name` of the parameters p (read or mirrored) on x."""
    return int8_matmul(x, p[name + ".weight_q"], p[name + ".scale"],
                       p[name + ".bias"], x.dtype)


def _softmax_probs(logits: torch.Tensor, dt, keep, rate) -> torch.Tensor:
    """softmax(logits) named attn_probs (before the cast, as JAX names
    it), cast to the compute dtype, with the attention dropout mask."""
    with remat.name("attn_probs"):
        probs = torch.softmax(logits, dim=-1)
    return apply_keep(probs.to(dt), keep, rate)


def _pv(probs: torch.Tensor, v: torch.Tensor, spec: str) -> torch.Tensor:
    """P.V named attn_inner. JAX's einsum promotes: int8 projections
    return their input's dtype, so under bf16 norms in an fp32 model v is
    bf16."""
    pdt = torch.promote_types(probs.dtype, v.dtype)
    with remat.name("attn_inner"):
        return torch.einsum(spec, probs.to(pdt), v.to(pdt))


def _plain_attention(impl: str, q, k, v, keep, rate: float, dt, ndt,
                     tp=None) -> torch.Tensor:
    """The JAX package's plain attention layouts (`occm_tpu/models/
    xlsr.py` SelfAttention): q (scaled), k, v [B, T, h, hd] (h: this
    rank's heads) -> [B, T, h, hd]. Logits and softmax at ndt, the
    probabilities cast to dt; keep: the [B, h, T, T] dropout mask, laid
    out as each layout's probabilities are. "xla": the two products over
    (B, H); "xla_merged": over one merged B*H dim; "pad128": T padded to a
    multiple of 128 for the products, the pad keys masked at -1e30 and the
    pad rows sliced off; "packed[N]": N heads at a time, q block-diagonal
    [N T, N hd] against the N heads' k side by side, so one product makes
    the N heads' logits (and P.V likewise)."""
    B, T, h, hd = q.shape
    if impl == "xla":
        with remat.name("attn_logits"):
            logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ndt), k.to(ndt))
        return _pv(_softmax_probs(logits, dt, keep, rate), v,
                   "bhqk,bkhd->bqhd")
    if impl == "xla_merged":
        qm = q.transpose(1, 2).reshape(B * h, T, hd)
        km = k.transpose(1, 2).reshape(B * h, T, hd)
        vm = v.transpose(1, 2).reshape(B * h, T, hd)
        with remat.name("attn_logits"):
            logits = torch.einsum("zqd,zkd->zqk", qm.to(ndt), km.to(ndt))
        keep = None if keep is None else keep.reshape(B * h, T, T)
        out = _pv(_softmax_probs(logits, dt, keep, rate), vm,
                  "zqk,zkd->zqd")
        return out.reshape(B, h, T, hd).transpose(1, 2)
    if impl == "pad128":
        tp_ = -(-T // 128) * 128
        pad = (0, 0, 0, 0, 0, tp_ - T)
        with remat.name("attn_logits"):
            logits = torch.einsum("bqhd,bkhd->bhqk",
                                  F.pad(q, pad).to(ndt),
                                  F.pad(k, pad).to(ndt))
        logits = torch.where(torch.arange(tp_, device=logits.device) < T,
                             logits, logits.new_full((), -1e30))
        if keep is not None:
            keep = F.pad(keep, (0, tp_ - T, 0, tp_ - T), value=True)
        out = _pv(_softmax_probs(logits, dt, keep, rate), F.pad(v, pad),
                  "bhqk,bkhd->bqhd")
        return out[:, :T]
    width = impl[len("packed"):]
    if not impl.startswith("packed") or not (width == "" or width.isdigit()):
        raise ValueError(
            f"unknown attention_impl {impl!r} (xla | xla_merged | packed[N] "
            "| pad128 | flash | skip)")
    g = int(width or 2)
    if g < 2 or h % g:
        where = "" if tp is None else (
            f" (this rank's {h} of the heads under tp={tp[1]})")
        raise ValueError(
            f"attention_impl={impl!r}: pack width {g} must be >=2 and "
            f"divide num_heads={h}{where}")
    P = h // g
    eye = torch.eye(g, dtype=q.dtype, device=q.device)[:, None, :, None]

    def heads(t):  # [B, T, h, hd] -> [B, P, g, T, hd]
        return t.transpose(1, 2).reshape(B, P, g, T, hd)

    qh, kh, vh = heads(q), heads(k), heads(v)
    kc = kh.transpose(2, 3).reshape(B, P, T, g * hd)
    # block-diagonal through an outer product with I_g:
    # [B, P, g, T, 1, hd] x [g, 1, g, 1] -> [B, P, gT, g hd]
    qp = (qh[:, :, :, :, None, :] * eye).reshape(B, P, g * T, g * hd)
    with remat.name("attn_logits"):
        logits = torch.einsum("bpqd,bpkd->bpqk", qp.to(ndt), kc.to(ndt))
    keep = None if keep is None else keep.reshape(B, P, g * T, T)
    probs = _softmax_probs(logits, dt, keep, rate)
    pc = (probs.reshape(B, P, g, T, T).transpose(2, 3)
          .reshape(B, P, T, g * T))
    vp = (vh[:, :, :, :, None, :] * eye.to(vh.dtype)).reshape(
        B, P, g * T, g * hd)
    out = _pv(pc, vp, "bpqk,bpkd->bpqd")
    return (out.reshape(B, P, T, g, hd).transpose(1, 2)
            .reshape(B, T, h, hd))


class SelfAttention(nn.Module):
    """Multi-head self-attention: bf16 projections (int8 ones with
    quant_int8, in the input's dtype), fp32 softmax."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        self.q_proj = _projection(cfg, d, d)
        self.k_proj = _projection(cfg, d, d)
        self.v_proj = _projection(cfg, d, d)
        self.out_proj = _projection(cfg, d, d)
        self._names = tuple(n for n, _ in self.named_parameters())

    def forward(self, x: torch.Tensor, impl: str,
                keep: Optional[torch.Tensor] = None,
                params: Optional[dict] = None,
                scatter_to: Optional[int] = None) -> torch.Tensor:
        """keep: the attention-probability dropout mask [B, H, T, T] (plain
        attention only), or None. params: the layer's bf16 mirror of this
        module's parameters, by name, or None to read them. scatter_to:
        under sequence parallelism, the padded frame count whose
        reduce-scatter gives this rank's block of the output (x is then
        the gathered frames), else None."""
        cfg = self.cfg
        dt = _DTYPES[cfg.dtype]
        ndt = _DTYPES[cfg.norm_dtype]
        hd = cfg.encoder_embed_dim // cfg.encoder_heads
        B, T, _ = x.shape
        p = _params_of(self, self._names) if params is None else params
        tp = tp_group()
        if tp is not None and scatter_to is None:
            x = copy_to(x, tp[0])

        def proj(y, name):
            if cfg.quant_int8:
                return _int8_linear(y, p, name)
            return _linear(y, p[name + ".weight"], p[name + ".bias"], dt,
                           tag="attn_out" if name == "out_proj" else
                           f"attn_{name[0]}")

        # under tp the projections give this rank's H/tp heads
        if cfg.fused_qkv and not cfg.quant_int8:
            # one [3d, d] product over the three weights concatenated here
            # (under tp the rank's shards of each), split into q, k, v
            names = ("q_proj", "k_proj", "v_proj")
            w = torch.cat([p[n + ".weight"] for n in names])
            b = torch.cat([p[n + ".bias"] for n in names])
            qkv = _linear(x, w, b, dt, tag="attn_qkv")
            q, k, v = qkv.reshape(B, T, 3, -1, hd).unbind(2)
        else:
            q = proj(x, "q_proj").reshape(B, T, -1, hd)
            k = proj(x, "k_proj").reshape(B, T, -1, hd)
            v = proj(x, "v_proj").reshape(B, T, -1, hd)
        if impl == "flash":
            # the kernel's output is named through a copy (models/remat.py)
            out = remat.kernel_output(flash_attention(q, k, v).to(dt),
                                      "attn_inner")
        elif impl == "skip":
            # NOT attention: V passed through, for timing attribution only
            # (XLSRConfig refuses it without allow_debug_impls)
            out = v
        else:
            out = _plain_attention(impl, q * (hd ** -0.5), k, v, keep,
                                   cfg.attention_dropout, dt, ndt, tp)
        out = out.reshape(B, T, -1)
        if tp is None:
            return proj(out, "out_proj")
        # row-parallel out_proj: the partial product summed over tp, then
        # the bias once
        part = _linear(out, p["out_proj.weight"], None, dt, tag="attn_out")
        if scatter_to is not None:
            part = scatter_frames(_pad_frames(part, scatter_to), tp[0])
        else:
            part = reduce_from(part, tp[0])
        return part + p["out_proj.bias"].to(dt)


class TransformerLayer(nn.Module):
    """Pre-/post-norm transformer block (fairseq
    TransformerSentenceEncoderLayer)."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.encoder_embed_dim, cfg.encoder_ffn_dim
        self.self_attn = SelfAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = _projection(cfg, d, f)
        self.fc2 = _projection(cfg, f, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self._names = tuple(n for n, _ in self.named_parameters())

    def _norm(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        weight, bias = p[name + ".weight"], p[name + ".bias"]
        eps = getattr(self, name).eps
        if self.cfg.ln_impl == "pallas":
            return fast_layer_norm(x, weight, bias, eps)
        return _layer_norm(x, weight, bias, _DTYPES[self.cfg.norm_dtype],
                           eps)

    def draw_masks(self, shape, device, impl: str,
                   gen: Optional[torch.Generator]):
        """The layer's dropout masks for an input of `shape` [B, T, D] on
        `device`, in the order its sites run: attention probabilities, the
        attention branch, the FFN activation, the FFN branch (None where a
        site's rate is 0 or there is no generator). Under tp the rank keeps
        its heads and FFN columns, and under sequence parallelism its
        frames of the two branch masks."""
        cfg = self.cfg
        if gen is None:
            return (None,) * 4
        if impl == "flash" and cfg.attention_dropout > 0.0:
            raise ValueError(
                'attention_impl="flash" cannot apply attention_dropout '
                "(the probabilities never materialise); train with "
                'attention_impl="xla" or zero the rate')
        if cfg.activation_dropout > 0.0 and (cfg.quant_int8
                                             or cfg.ffn_impl == "pallas"):
            raise ValueError(
                "activation_dropout needs the hidden FFN activation "
                'materialised: train with ffn_impl="xla" and without '
                "quant_int8, or zero the rate")
        B, T, d = shape
        shapes = ((B, cfg.encoder_heads, T, T), (B, T, d),
                  (B, T, cfg.encoder_ffn_dim), (B, T, d))
        # "skip" has no probabilities to drop
        rates = (0.0 if impl == "skip" else cfg.attention_dropout,
                 cfg.dropout, cfg.activation_dropout, cfg.dropout)
        masks = [dropout_keep(s, p, gen, device) if p > 0.0
                 else None for s, p in zip(shapes, rates)]
        tp = tp_group()
        if tp is not None:
            # drawn whole on every rank (the generators stay in step); the
            # rank keeps its heads and its FFN columns
            _, n, i = tp
            for j, dim in ((0, 1), (2, 2)):
                if masks[j] is not None:
                    size = masks[j].shape[dim] // n
                    masks[j] = masks[j].narrow(dim, i * size, size)
        sp = _sp(cfg)
        if sp is not None:
            for j in (1, 3):
                if masks[j] is not None:
                    masks[j] = _frame_block(masks[j], sp)
        return tuple(masks)

    def forward(self, x: torch.Tensor, impl: str,
                masks=(None, None, None, None),
                params: Optional[dict] = None,
                frames: Optional[int] = None) -> torch.Tensor:
        """masks: `draw_masks`' tuple (all None: no dropout). params: the
        layer's parameters by name (the encoder's bf16 mirror), or None to
        read them. frames: under sequence parallelism, the frame count T
        (x is then this rank's block of the padded frames)."""
        cfg = self.cfg
        dt = _DTYPES[cfg.dtype]
        pre = cfg.layer_norm_first
        keep_attn, keep_res1, keep_act, keep_res2 = masks
        p = _params_of(self, self._names) if params is None else params
        attn_p = {k[len("self_attn."):]: v for k, v in p.items()
                  if k.startswith("self_attn.")}
        sp = _sp(cfg)
        padded = None if sp is None else x.shape[1] * sp[1]

        def gathered(h):
            # the whole frames, the pad sliced off, contiguous: F.linear
            # fuses its bias into the product only on a contiguous input,
            # so the projections then round as tp's do
            if sp is None:
                return h
            return gather_frames(h, sp[0])[:, :frames].contiguous()

        residual = x
        h = self._norm(p, "self_attn_layer_norm", x) if pre else x
        h = apply_keep(self.self_attn(gathered(h), impl, keep_attn, attn_p,
                                      padded), keep_res1, cfg.dropout)
        x = residual + h
        if not pre:
            x = self._norm(p, "self_attn_layer_norm", x).to(dt)

        residual = x
        h = self._norm(p, "final_layer_norm", x) if pre else x
        tp = tp_group()
        b2 = p["fc2.bias"]
        if sp is not None:
            h = gathered(h)
            b2 = torch.zeros_like(b2)
        elif tp is not None:
            h = copy_to(h, tp[0])
            # row-parallel fc2: its bias is added once, after the sum
            b2 = torch.zeros_like(b2)
        if cfg.quant_int8:
            # taken before ffn_impl, as in JAX: the int8 FFN in h's dtype
            h = _gelu(_int8_linear(h, p, "fc1"), cfg.gelu_approximate)
            h = _int8_linear(h, p, "fc2")
        elif cfg.ffn_impl == "pallas":
            # fused fc1 + GELU + fc2 (ops/ffn.py): the weights in the compute
            # dtype, fc1/fc2 in nn.Linear's layout, passed as W1 = fc1.weight^T
            # and W2 = fc2.weight^T (views; the kernel reads them untransposed)
            h = fused_ffn(h.to(dt), p["fc1.weight"].to(dt).t(),
                          p["fc1.bias"].to(dt), p["fc2.weight"].to(dt).t(),
                          b2.to(dt), cfg.gelu_approximate)
        else:
            h = _gelu(_linear(h, p["fc1.weight"], p["fc1.bias"], dt,
                              tag="fc1"), cfg.gelu_approximate)
            h = apply_keep(h, keep_act, cfg.activation_dropout)
            h = _linear(h, p["fc2.weight"], None if tp else b2, dt)
        if sp is not None:
            h = scatter_frames(_pad_frames(h, padded), tp[0]) \
                + p["fc2.bias"].to(dt)
        elif tp is not None:
            h = reduce_from(h, tp[0]) + p["fc2.bias"].to(dt)
        h = apply_keep(h, keep_res2, cfg.dropout)
        x = residual + h
        if not pre:
            x = self._norm(p, "final_layer_norm", x).to(dt)
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


@dataclasses.dataclass
class StagePass:
    """A rank's pipeline stages' forward, kept for its backward: the pp
    group, the global ranks of the pipeline's ranks before and after this
    one (None at the ends), the rank's first and last stage, on the first
    rank the stack's input as the frontend made it (`x0`) and as the leaf
    its microbatches' backwards accumulate into (`whole`), and in tick
    order per (stage, microbatch) run: (stage, microbatch, its input, its
    output, on the pipeline's last stage that output as a leaf)."""
    group: object
    prev: Optional[int]
    next: Optional[int]
    first: int
    last: int
    x0: Optional[torch.Tensor]
    whole: Optional[torch.Tensor]
    parts: list


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

    #: a pipeline stage's last forward, for its backward (`train.loop`
    #: takes it), or None
    stage_pass = None

    def forward(self, x: torch.Tensor,
                attention_impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None
                ) -> Optional[torch.Tensor]:
        """attention_impl overrides cfg.attention_impl (any value it
        takes), so one set of weights serves buckets that pick different
        impls.
        generator: the generator of the dropout masks in train mode. On a
        mesh with pp > 1 the rank's pipeline stage (`stage_forward`): the
        features on the last stage, None on the others."""
        impl = attention_impl or self.cfg.attention_impl
        gen = train_generator(self, generator)
        pp = pp_group()
        if pp is not None:
            return self.stage_forward(x, impl, gen, pp)
        x = self.embed(x, impl, gen)
        layers = range(len(self.encoder.layers))
        draws = self.draw_layers(x.shape, x.device, impl, gen, layers)
        mirror = self.mirror(layers)
        micro = self.microbatches(x.shape[0])
        if len(micro) == 1:
            x = self.run_layers(x, impl, draws, layers, mirror)
        else:
            # JAX's pipelined stack in one process: the microbatches in
            # turn through every layer, the same function
            x = torch.cat([self.run_layers(x[rows], impl, draws, layers,
                                           mirror, rows) for rows in micro])
        return self.head(x)

    def stage_forward(self, x: torch.Tensor, impl: str,
                      gen: Optional[torch.Generator], pp
                      ) -> Optional[torch.Tensor]:
        """This rank's stages of the GPipe schedule's forward over S =
        pp_stages stages (`pp`: pp_group()'s (group, P, r); P must divide
        S): rank r runs stages [r S/P, (r + 1) S/P), stage s layers
        [s L/S, (s + 1) L/S), over the M + S - 1 ticks of the schedule, at
        tick t each of its stages s on microbatch t - s. The first stage of
        the rank receives its microbatches from rank r - 1 (rank 0 embeds
        the wave x; the others read only its shape), a stage hands its
        output to the next one on the same rank locally (a leaf, so each
        stage's backward runs on its own), and the rank's last stage sends
        it on to rank r + 1, every rank posting them in schedule order.
        The dropout generator comes from rank r - 1 before this rank draws
        its layers' masks and goes on to rank r + 1 after, so each draws
        after the one before, as one process draws. Returns the features
        on the last rank (its microbatches' outputs gathered, as leaves
        whose gradients start the backward), else None; leaves the
        backward's record in `stage_pass`."""
        group, P, r = pp
        cfg = self.cfg
        S = cfg.pp_stages
        if S % P:
            raise ValueError(
                f"a mesh with pp={P} runs pp_stages in blocks of S / pp "
                f"per rank: pp={P} must divide pp_stages={S}")
        mesh = current_mesh()
        micro = self.microbatches(x.shape[0])
        per = cfg.encoder_layers // S
        first, last = r * (S // P), (r + 1) * (S // P) - 1
        layers = range(first * per, (last + 1) * per)
        prev = pp_peer(mesh, r - 1) if r > 0 else None
        nxt = pp_peer(mesh, r + 1) if r < P - 1 else None
        x0 = whole = None
        if prev is None:
            # the stack's input as a leaf: the microbatches' backwards
            # accumulate into it, and the frontend's runs once
            x0 = self.embed(x, impl, gen)
            whole = x0.detach().requires_grad_(x0.requires_grad)
            shape = whole.shape
        else:
            if gen is not None:
                state = gen.get_state()
                gen.set_state(recv(tuple(state.shape), state.dtype, prev,
                                   "cpu", group))
            shape = (x.shape[0], self.frames(x.shape[-1]),
                     cfg.encoder_embed_dim)
        draws = self.draw_layers(shape, x.device, impl, gen, layers)
        if nxt is not None and gen is not None:
            send(gen.get_state(), nxt, group)
        mirror = self.mirror(layers)
        parts, handed = [], {}
        for t in range(len(micro) + S - 1):
            for stage in range(first, last + 1):
                m = t - stage
                if not 0 <= m < len(micro):
                    continue
                rows = micro[m]
                if stage > first:
                    h = handed.pop(m)
                elif whole is not None:
                    h = whole[rows]
                else:
                    h = recv((rows.stop - rows.start,) + tuple(shape[1:]),
                             _DTYPES[cfg.dtype], prev, x.device,
                             group).requires_grad_()
                y = self.run_layers(h, impl, draws,
                                    range(stage * per, (stage + 1) * per),
                                    mirror, rows)
                out = None
                if stage < last:
                    handed[m] = y.detach().requires_grad_(y.requires_grad)
                elif nxt is not None:
                    send(y, nxt, group)
                else:
                    out = y.detach().requires_grad_()
                parts.append((stage, m, h, y, out))
        self.stage_pass = StagePass(group, prev, nxt, first, last, x0, whole,
                                    parts)
        if nxt is None:
            outs = {m: out for stage, m, _, _, out in parts
                    if stage == last}
            return self.head(torch.cat([outs[m] for m in range(len(micro))]))
        return None

    def frames(self, samples: int) -> int:
        """The frame count of a wave of `samples` samples."""
        n = samples
        for _, k, s in self.cfg.conv_layers:
            n = (n - k) // s + 1
        return n

    def embed(self, x: torch.Tensor, impl: str,
              gen: Optional[torch.Generator]) -> torch.Tensor:
        """Raw wave [B, T] -> the layer stack's input [B, frames, D] in the
        compute dtype: the conv extractor, its LayerNorm, post_extract_proj,
        dropout_input, the positional conv (and the post-norm LayerNorm)
        and the encoder's input dropout."""
        cfg = self.cfg
        dt = _DTYPES[cfg.dtype]
        if cfg.quant_int8 and tp_group() is not None:
            raise ValueError(
                "quant_int8 has no tensor-parallel split (an int8 row "
                "quantised over a column shard is another function); score "
                "int8 on a data-parallel mesh")
        train_remat = self.training and torch.is_grad_enabled()
        if x.dim() == 3:  # the reference squeezes a trailing channel dim
            x = x[:, :, 0]
        if cfg.conv_remat and train_remat:
            feats = checkpoint(self.feature_extractor, x, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            feats = self.feature_extractor(x)
        # fairseq GradMultiply: scale (or stop) the gradient into the convs
        if cfg.feature_grad_mult == 0.0:
            feats = feats.detach()
        elif cfg.feature_grad_mult != 1.0:
            feats = grad_multiply(feats, cfg.feature_grad_mult)
        feats = _ln(feats, self.layer_norm, torch.float32).to(dt)
        if self.post_extract_proj is not None:
            feats = _linear(feats, self.post_extract_proj.weight,
                            self.post_extract_proj.bias, dt)
        feats = dropout(feats, cfg.dropout_input, gen)

        pos = self.encoder.pos_conv[0](feats)[:, : feats.shape[1], :]
        x = feats + _gelu(pos, cfg.conv_gelu_approximate)
        if not cfg.layer_norm_first:
            x = _ln(x, self.encoder.layer_norm, torch.float32).to(dt)
        return dropout(x, cfg.dropout, gen)

    def draw_layers(self, shape, device, impl: str,
                    gen: Optional[torch.Generator], layers) -> dict:
        """layer -> (layerdrop keep flag or None, its dropout masks) for a
        stack input of `shape` on `device`, drawn in layer order (the
        sequential stack's order) for the whole batch."""
        cfg = self.cfg
        draws = {}
        for l in layers:
            keep = None
            if gen is not None and cfg.layerdrop > 0.0:
                # fairseq encoder_layerdrop: drop the layer with probability
                # p; the flag is drawn on the generator's device
                keep = (torch.rand((), generator=gen, device=gen.device)
                        >= cfg.layerdrop).to(device)
            draws[l] = (keep, self.encoder.layers[l].draw_masks(
                shape, device, impl, gen))
        return draws

    def mirror(self, layers) -> dict:
        """layer -> its parameters by name for the forward: with
        bf16_param_mirror JAX's nn.map_variables mirror, every fp32
        parameter of these layers cast to bf16 once per forward
        (LayerNorms included), which every use in the layers reads (the
        gradients flow back to the fp32 leaves through this one cast);
        else None (the layers read their parameters)."""
        if not self.cfg.bf16_param_mirror:
            return dict.fromkeys(layers)
        return {l: {n: w.to(torch.bfloat16) if w.dtype == torch.float32
                    else w for n, w in
                    self.encoder.layers[l].named_parameters()}
                for l in layers}

    def microbatches(self, rows: int) -> list:
        """The row slices the stack runs in turn: the whole batch, or with
        pp_stages S > 1 its M = pp_microbatches (0: S) microbatches. Raises
        JAX's ValueErrors when S does not divide the layers or M the rows
        this encoder is given (under GSPMD JAX checks the global batch;
        here they are this rank's rows)."""
        cfg = self.cfg
        S = cfg.pp_stages
        if S == 1:
            return [slice(None)]
        L = cfg.encoder_layers
        if L % S:
            raise ValueError(
                f"pp_stages={S} must divide encoder_layers={L}")
        M = cfg.pp_microbatches or S
        if rows % M:
            raise ValueError(
                f"pp_microbatches={M} must divide batch size {rows} (the "
                "rows this rank's encoder is given)")
        mb = rows // M
        return [slice(m * mb, (m + 1) * mb) for m in range(M)]

    def run_layers(self, x: torch.Tensor, impl: str, draws: dict, layers,
                   mirror: dict, rows: Optional[slice] = None
                   ) -> torch.Tensor:
        """`layers` of the stack on x [b, T, D] (rows `rows` of the batch
        the draws were made for, or all of it), with remat per layer in
        training. Under sequence parallelism x is cut to this rank's block
        of the frames here and gathered whole again at the end."""
        cfg = self.cfg
        train_remat = self.training and torch.is_grad_enabled()
        sp = _sp(cfg)
        frames = x.shape[1]
        if sp is not None:
            x = _frame_block(x, sp)
        for l in layers:
            layer = self.encoder.layers[l]
            keep, masks = draws[l]
            if rows is not None:
                masks = tuple(None if m is None else m[rows] for m in masks)
            if cfg.remat and train_remat:
                # the masks are inputs, so the recompute draws nothing
                y = remat.checkpoint_layer(layer, cfg.remat_policy, x, impl,
                                           masks, mirror[l], frames)
            else:
                y = layer(x, impl, masks, mirror[l], frames)
            # the layer always runs and a dropped one is discarded on the
            # device, as the JAX package's where(keep, y, carry)
            x = y if keep is None else torch.where(keep, y, x)
        if sp is not None:
            x = gather_rows(x, sp[0], dim=1)[:, :frames]
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The stack's output -> the features, fp32 (the encoder LayerNorm
        of the pre-norm layout)."""
        if self.cfg.layer_norm_first:
            x = _ln(x, self.encoder.layer_norm, torch.float32)
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
