"""Fused multi-head attention for the XLSR transformer, forward and
backward.

`flash_attention(q, k, v)` on [B, T, H, D] is the port of
`occm_tpu.ops.attention.flash_attention`, a `torch.autograd.Function`. On a
CUDA tensor its forward launches the hand-written Hopper kernel
`csrc/flash_attn_fwd.cu` (`wgmma` fed by TMA), which replaces both TPU
forward kernels (the whole-T `_fwd_kernel` and the blocked online-softmax
`_blocked_fwd_kernel`; their split at T = 512 only existed for TPU VMEM).
It reads q, k, v where the projections leave them and writes out
contiguous as [B, T, H, D], so neither side needs a layout copy. Its
backward launches the two kernels of `csrc/flash_attn_bwd.cu` (dq, which
also computes δ = rowsum(dO ⊙ O), then dk and dv), fed by the forward's
lse; they read q, k, v, out and dO in place the same way and write the
gradients contiguous as [B, T, H, D]: two device launches a call and no
copies. They replace the three TPU backward kernels (`_bwd_kernel`,
`_blocked_dq_kernel`, `_blocked_dkv_kernel`). On a CPU
tensor the same Function runs `flash_attention_reference` and
`flash_attention_bwd_reference`, the kernels' plain PyTorch versions: same
masking, scale folding and dtype casts. A tensor on any other device
raises; nothing falls back from a kernel to its plain version.

Three CUDA routes (`cuda_route`), which between them take bf16 and fp32
at every head dim D >= 1, as the TPU kernels do:
- "wgmma": bf16 at every head dim D that is a multiple of 8 from 8 to 256
  takes the kernels above, one template instance for each
  round_up(D, 16) (above 128 the dk/dv kernel is a wider one: two
  consumer warpgroups, one for dv and one for dk). D = 64 and D = 256 are
  instances of their own (`LOGITS_SCALE_HEAD_DIMS`: they scale the fp32
  logits, exact for 2^-3 and 2^-4); the others fold the scale into q
  before the bf16 cast, as the TPU kernels do, and their backward keeps
  that folded q in a [B, T, H, D] scratch tensor for the dk/dv kernel.
  Launches off D 64 count apart (`OTHER_D_*`). Above 256
  (`WGMMA_MAX_SINGLE_PANEL`) the route takes the three kernels of
  `csrc/flash_attn_panel.cu`, which split the output along D into panels
  of 192 or 256 columns, a block each, and stream q k^T (and dO v^T) over
  the whole D in 64-column steps; they fold the scale into each streamed
  q panel and need no scratch tensor. Their launches count on `PANEL_*`.
- "3xtf32": fp32 at the head dims of `TF32_FWD_HEAD_DIMS` takes, for the
  forward, `csrc/flash_attn_fwd_3xtf32.cu` (`wgmma` fed by TMA on the
  tensor cores in 3xTF32, fp32 sums), which replaces the two TPU forward
  kernels in fp32.
- "generic": fp32 at any other D, and bf16 at a D that is not a
  multiple of 8, take the three kernels of `csrc/flash_attn_generic.cu`
  (forward, dq with δ, dk/dv: FFMA on the CUDA cores, true fp32; above
  D 256 the output split into panels of 256 columns, a block each), which
  replace the same five TPU kernels for what the other kernels do not
  take.
The backward has its own table (`cuda_bwd_route`): "3xtf32", fp32 at the
head dims of `TF32_BWD_HEAD_DIMS`, takes the two kernels of
`csrc/flash_attn_bwd_3xtf32_dq.cu` and `_dkv.cu` (dq with δ, then dk/dv:
`mma.sync` on the tensor cores in 3xTF32, fp32 sums); any other fp32 D
keeps the generic pair, and bf16 takes its forward's route. The backward
is fed by its own forward's lse whichever kernel made it. The generic
kernels and the 3xTF32 backward read any strides in place; on the wgmma
route and the 3xTF32 forward a [B, T, H, D] input whose strides the TMA
maps cannot read raises (the autograd Function copies such a dO, an
expanded one, for the wgmma backward first). Whatever no route takes
raises.

For every T the port casts the unnormalised probabilities to bf16 before
P·V and divides by the row sum afterwards, as the blocked TPU kernel does;
the whole-T TPU kernel normalises before the cast. In bf16 the two differ
by one rounding of P (relative 2^-9); in fp32 they agree.

`reference_attention` is the plain einsum attention (the "xla" impl).
"""

from __future__ import annotations

import math

import torch

#: launches of each kernel since the last reset (chip_smoke.py reads and
#: resets them): the forward, and the backward's dq and dk/dv kernels, at
#: head dim 64
LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
#: the same kernels' instances at the wgmma route's other head dims
OTHER_D_LAUNCHES = 0
OTHER_D_BWD_DQ_LAUNCHES = 0
OTHER_D_BWD_DKV_LAUNCHES = 0
#: copies of a CUDA dO whose strides the backward's TMA maps cannot read
#: (an expanded stride 0, say), made before the wgmma backward kernels
BWD_DOUT_COPIES = 0
#: launches of the generic route's kernels (csrc/flash_attn_generic.cu)
GENERIC_LAUNCHES = 0
GENERIC_BWD_DQ_LAUNCHES = 0
GENERIC_BWD_DKV_LAUNCHES = 0
#: launches of the 3xTF32 forward (csrc/flash_attn_fwd_3xtf32.cu)
TF32_FWD_LAUNCHES = 0
#: launches of the 3xTF32 backward pair (csrc/flash_attn_bwd_3xtf32_*.cu)
TF32_BWD_DQ_LAUNCHES = 0
TF32_BWD_DKV_LAUNCHES = 0
#: launches of the wgmma route's panel kernels above head dim 256
#: (csrc/flash_attn_panel.cu): the forward, and the backward's dq and dk/dv
PANEL_LAUNCHES = 0
PANEL_BWD_DQ_LAUNCHES = 0
PANEL_BWD_DKV_LAUNCHES = 0


class HeadDims:
    """The head dims from `first` up in steps of `step`, with no end:
    `d in HeadDims(8, 8)` for every multiple of 8."""

    def __init__(self, first: int, step: int = 1):
        self.first, self.step = first, step

    def __contains__(self, d) -> bool:
        return d >= self.first and (d - self.first) % self.step == 0

    def __repr__(self) -> str:
        return f"HeadDims({self.first}, {self.step})"


#: head dims the wgmma route takes in bf16: every multiple of 8
WGMMA_HEAD_DIMS = HeadDims(8, 8)
#: the largest head dim of the single-panel wgmma kernels
#: (csrc/flash_attn_fwd.cu, flash_attn_bwd.cu); above it the panel kernels
#: (csrc/flash_attn_panel.cu) take the wgmma route's head dims
WGMMA_MAX_SINGLE_PANEL = 256
#: head dims whose wgmma instances scale the fp32 logits rather than fold
#: the scale into q: 1/sqrt(D) is 2^-3 and 2^-4, so bf16(q * scale) is
#: bf16(q) * scale and both orders give the same bits; their backward needs
#: no folded-q scratch tensor
LOGITS_SCALE_HEAD_DIMS = (64, 256)
#: head dims the generic kernels take: every D >= 1 (a padded bucket of
#: 16 to 256 columns, above 256 panels of 256)
GENERIC_HEAD_DIMS = HeadDims(1)
#: head dims at which the fp32 backward takes the 3xTF32 pair: the
#: multiples of 8 from 8 to 128 (the kernels' instances are round_up(D, 16)
#: columns wide). The generic pair keeps every other fp32 D. chip_smoke.py
#: phase 20's sweep (B 12, H 16, T 299, wrapper ms in turns, an NVIDIA H100
#: 80GB HBM3 at a 700 W power limit) found the 3xTF32 pair ahead at every
#: one of them, 3xTF32 against generic:
#:   D   8  0.1648, 0.2885    D  72  0.9581, 1.8468
#:   D  16  0.1752, 0.3087    D  80  0.9432, 1.8484
#:   D  24  0.2771, 0.4879    D  88  1.0931, 1.8532
#:   D  32  0.2776, 0.4846    D  96  1.0774, 1.8515
#:   D  40  0.4114, 0.8821    D 104  1.4054, 1.8846
#:   D  48  0.4180, 0.8909    D 112  1.4110, 1.8915
#:   D  56  0.5208, 0.8940    D 120  1.6965, 1.9008
#:   D  64  0.5145, 0.8764    D 128  1.5944, 1.8384
#: and at the tiny model's D 16, B 12, H 4 on device time 0.0480 against
#: 0.0873 ms.
TF32_BWD_HEAD_DIMS = range(8, 129, 8)
#: head dims at which the fp32 forward takes the 3xTF32 kernel
#: (csrc/flash_attn_fwd_3xtf32.cu, one instance for each round_up(D, 16)):
#: the multiples of 8 from 8 to 128. The generic forward keeps every other
#: fp32 D. chip_smoke.py phase 20's sweep (B 8, T 299, wrapper ms in turns
#: and device ms, an NVIDIA H100 80GB HBM3 at a 700 W power limit) found
#: the 3xTF32 kernel ahead on the device at every one of them, device ms
#: 3xTF32 against generic at H 16:
#:   D   8  0.0294, 0.0550    D  72  0.1200, 0.2897
#:   D  16  0.0296, 0.0542    D  80  0.1233, 0.2909
#:   D  24  0.0385, 0.0832    D  88  0.1305, 0.2913
#:   D  32  0.0388, 0.0771    D  96  0.1283, 0.2907
#:   D  40  0.0502, 0.1510    D 104  0.1481, 0.2900
#:   D  48  0.0508, 0.1505    D 112  0.1481, 0.2902
#:   D  56  0.0630, 0.1681    D 120  0.1672, 0.2930
#:   D  64  0.0632, 0.1445    D 128  0.1625, 0.2827
#: and at the tiny model's D 16, H 4: 0.0104 against 0.0235 (its wrapper
#: ms, 0.0350 against 0.0298, are the host's launch cost of either kernel,
#: three TMA maps for this one). The wrapper ms were ahead at every H 16
#: row too (D 16: 0.0554 against 0.0586).
TF32_FWD_HEAD_DIMS = range(8, 129, 8)
#: the generic kernels' dtype codes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def cuda_route(dtype: torch.dtype, head_dim: int):
    """The CUDA forward kernel that takes q, k, v of this dtype and head
    dim: "wgmma" (bf16 with D a multiple of 8: csrc/flash_attn_fwd.cu up
    to 256 and csrc/flash_attn_panel.cu above, and flash_attn_bwd.cu or
    the panel file's pair for the backward), "3xtf32" (fp32 with D in
    TF32_FWD_HEAD_DIMS: csrc/flash_attn_fwd_3xtf32.cu), "generic" (fp32 at
    any other D >= 1, and bf16 at a D that is not a multiple of 8, whose
    rows TMA cannot read: csrc/flash_attn_generic.cu), or None (another
    dtype, or D < 1: raises on a CUDA tensor; on a CPU tensor the plain
    version takes any).

    Above D 256 the wgmma kernels of csrc/flash_attn_fwd.cu and
    flash_attn_bwd.cu do not fit (the dq kernel's seven 64-row tiles fill
    225 of an SM's 227 KB at D 256, their accumulators hold 128 fp32
    registers a thread there, and one wgmma's N ends at 256), so the panel
    kernels split the output along D into panels of at most 256 columns,
    one a block, and stream q k^T (and dO v^T) over the whole D; the
    generic kernels do the same with panels of 256 columns. Each panel's
    block recomputes S (and dP): PERF.md has the factor and the times."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.float32 and head_dim in TF32_FWD_HEAD_DIMS:
        return "3xtf32"
    if dtype in _DTYPE_CODE and head_dim in GENERIC_HEAD_DIMS:
        return "generic"
    return None


def cuda_bwd_route(dtype: torch.dtype, head_dim: int):
    """The CUDA backward kernels that take q, k, v of this dtype and head
    dim: "3xtf32" (fp32 with D in TF32_BWD_HEAD_DIMS:
    csrc/flash_attn_bwd_3xtf32_dq.cu, _dkv.cu), "generic" at any other fp32
    D >= 1 (whichever kernel ran the forward), else the forward's
    `cuda_route`."""
    if dtype == torch.float32 and head_dim in TF32_BWD_HEAD_DIMS:
        return "3xtf32"
    route = cuda_route(dtype, head_dim)
    return "generic" if route == "3xtf32" else route


def cuda_kernel_takes(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a CUDA route takes q, k, v of this dtype and head dim."""
    return cuda_route(dtype, head_dim) is not None


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, t_valid: int):
    """Plain version of the kernel on its own layout: q, k, v [BH, T, D]
    (keys at index >= t_valid masked) -> (out [BH, T, D] in q's dtype,
    lse [BH, T] fp32). Mirrors the blocked TPU kernel's arithmetic: scale
    folded into q in fp32 before the cast to q's dtype, fp32 logits and
    softmax, unnormalised probabilities cast to v's dtype for the P·V
    product, fp32 sum divided by the row sum at the end."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q.float() * scale).to(q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(col >= t_valid, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return out, lse


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B * H, T, D] (a copy)."""
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D)


def _strides(x: torch.Tensor, four_d: bool):
    """(sb, st, sh, sd) of [B, T, H, D], or of [BH, T, D] read as B = BH,
    H = 1 (its H stride given as D)."""
    if four_d:
        return x.stride()
    (sb, st, sd), sh = x.stride(), x.shape[-1]
    return sb, st, sh, sd


def _tma_readable(x: torch.Tensor, four_d: bool) -> bool:
    """Whether the kernels' TMA maps read x where it lies: the head dim
    contiguous, 16-byte aligned, the other strides positive multiples of
    16 bytes (8 bf16 or 4 fp32 elements)."""
    sb, st, sh, sd = _strides(x, four_d)
    grid = 16 // x.element_size()
    return (sd == 1 and x.data_ptr() % 16 == 0 and min(sb, st, sh) > 0
            and sb % grid == st % grid == sh % grid == 0)


def _strides4(x: torch.Tensor, four_d: bool):
    """(data_ptr, sb, st, sh, sd) of a CUDA [B, T, H, D] tensor, or of
    [BH, T, D] read as B = BH, H = 1, as the generic kernels take them (any
    strides)."""
    if four_d:
        return (x.data_ptr(), *x.stride())
    sb, st, sd = x.stride()
    return x.data_ptr(), sb, st, x.shape[-1] * sd, sd


def _route(dtypes, head_dim: int, backward: bool = False) -> str:
    """The CUDA route (`cuda_route`, or `cuda_bwd_route` for the backward)
    of tensors of these dtypes, or ValueError."""
    table = cuda_bwd_route if backward else cuda_route
    route = (table(dtypes[0], head_dim)
             if len(set(dtypes)) == 1 else None)
    if route is None:
        raise ValueError(
            "the CUDA kernels take bf16 or fp32 with a head dim of 1 or more "
            f"(one dtype for every input), got {[str(d) for d in dtypes]} "
            f"with head dim {head_dim}")
    return route


def _launch_args(x: torch.Tensor, four_d: bool):
    """(data_ptr, sb, st, sh) of a CUDA [B, T, H, D] tensor, or of [BH, T, D]
    read as B = BH, H = 1, as the kernels take them; raises ValueError for
    what their TMA maps cannot read."""
    if not _tma_readable(x, four_d):
        raise ValueError(
            "the CUDA kernels take tensors with the head dim contiguous, "
            "16-byte aligned, and the other strides positive multiples of "
            f"16 bytes; got strides {tuple(x.stride())}")
    return (x.data_ptr(), *_strides(x, four_d)[:3])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        t_valid: int):
    """The kernel's wrapper: q, k, v [BH, T, D] or [B, T, H, D] -> (out of
    the same shape, contiguous, in q's dtype, lse [BH, T] fp32).

    CUDA tensors launch, on the current stream, `occm_flash_attn_fwd`
    (bf16, D a multiple of 8 from 8 to 256), `occm_flash_attn_panel_fwd`
    (bf16, D a multiple of 8 above 256), `occm_flash_attn_3xtf32_fwd`
    (fp32 at TF32_FWD_HEAD_DIMS) or `occm_flash_attn_generic_fwd` (fp32 at
    any other D, bf16 at any other D), as `cuda_route` says; [B, T, H, D]
    is read through its strides, so the projections' output needs no copy.
    CPU tensors take the plain version."""
    global LAUNCHES, OTHER_D_LAUNCHES, PANEL_LAUNCHES
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, "
            f"{v.device}")
    if q.dim() not in (3, 4) or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"expected q, k, v of one shape [BH, T, D] or [B, T, H, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    four_d = q.dim() == 4
    B, T, H, D = q.shape if four_d else (q.shape[0], q.shape[1], 1,
                                         q.shape[2])
    if not 1 <= t_valid <= T:
        raise ValueError(f"t_valid={t_valid} outside [1, {T}]")
    if q.device.type == "cpu":
        if not four_d:
            return flash_attention_reference(q, k, v, t_valid)
        out, lse = flash_attention_reference(
            *(_flat(x) for x in (q, k, v)), t_valid)
        return out.view(B, H, T, D).permute(0, 2, 1, 3).contiguous(), lse
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    route = _route((q.dtype, k.dtype, v.dtype), D)
    if route == "generic":
        return _generic_fwd(q, k, v, t_valid, four_d, B, H, T, D)
    if route == "3xtf32":
        return _tf32_fwd(q, k, v, t_valid, four_d, B, H, T, D)
    if D > WGMMA_MAX_SINGLE_PANEL:
        out, lse = _tma_fwd("occm_flash_attn_panel_fwd", q, k, v, t_valid,
                            four_d, B, H, T, D)
        PANEL_LAUNCHES += 1
        return out, lse
    out, lse = _tma_fwd("occm_flash_attn_fwd", q, k, v, t_valid, four_d, B,
                        H, T, D, int(D not in LOGITS_SCALE_HEAD_DIMS))
    if D == 64:
        LAUNCHES += 1
    else:
        OTHER_D_LAUNCHES += 1
    return out, lse


def _tma_fwd(entry, q, k, v, t_valid, four_d, B, H, T, D, *fold):
    """One launch of a TMA forward kernel's entry point (`entry`:
    `occm_flash_attn_fwd`, `occm_flash_attn_panel_fwd` or
    `occm_flash_attn_3xtf32_fwd`, which take the same arguments, the first
    one more: `fold`, 1 to fold the scale into q, 0 to scale the logits)
    on the current stream; raises ValueError for strides their maps cannot
    read."""
    qp, *qs = _launch_args(q, four_d)
    kp, *ks = _launch_args(k, four_d)
    vp, *vs = _launch_args(v, four_d)

    from occm_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    with _build.on_device(q.device):
        err = getattr(lib, entry)(
            qp, kp, vp, out.data_ptr(), lse.data_ptr(), B, H, T, t_valid, D,
            *qs, *ks, *vs, 1.0 / math.sqrt(D), _build.raw_stream(q.device),
            *fold)
    if err != 0:
        raise RuntimeError(f"{entry} failed: error {err}")
    return out, lse


def _tf32_fwd(q, k, v, t_valid, four_d, B, H, T, D):
    """One launch of `occm_flash_attn_3xtf32_fwd` on the current stream."""
    global TF32_FWD_LAUNCHES
    out, lse = _tma_fwd("occm_flash_attn_3xtf32_fwd", q, k, v, t_valid,
                        four_d, B, H, T, D)
    TF32_FWD_LAUNCHES += 1
    return out, lse


def _generic_fwd(q, k, v, t_valid, four_d, B, H, T, D):
    """One launch of `occm_flash_attn_generic_fwd` on the current stream."""
    global GENERIC_LAUNCHES
    from occm_tpu_torch.ops import _build

    lib = _build.load()
    (qp, *qs), (kp, *ks), (vp, *vs) = (_strides4(x, four_d)
                                       for x in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    with _build.on_device(q.device):
        err = lib.occm_flash_attn_generic_fwd(
            qp, kp, vp, out.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype],
            B, H, T, t_valid, D, *qs, *ks, *vs, 1.0 / math.sqrt(D),
            _build.raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"occm_flash_attn_generic_fwd failed: error {err}")
    GENERIC_LAUNCHES += 1
    return out, lse


def flash_attention_bwd_delta(o: torch.Tensor,
                              do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ⊙ O) in fp32, as the TPU wrapper computes it for its
    backward kernels: o, do [BH, T, D] or [B, T, H, D] -> [BH, T], the
    layout of lse (the dq kernel computes the same and writes it there)."""
    if o.dim() == 4:
        o, do = _flat(o), _flat(do)
    return torch.sum(do.float() * o.float(), dim=-1)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  t_valid: int):
    """Plain version of the backward kernels: q, k, v, o, do of one shape,
    [BH, T, D] or [B, T, H, D], lse [BH, T] fp32 -> (dq, dk, dv) of that
    shape, contiguous, in q's dtype. Mirrors the blocked TPU backward
    (`_blocked_p_ds`, `_blocked_dq_kernel`, `_blocked_dkv_kernel`):
    P = exp(S - lse) in fp32 from the scaled bf16 q, δ = rowsum(dO ⊙ O) in
    fp32, dS = P ⊙ (dO·Vᵀ − δ), P and dS cast to the input dtype before
    their products, fp32 accumulation, dq and dk times the scale (dk from
    the unscaled q); keys at index >= t_valid get no probability."""
    if q.dim() == 4:
        B, T, H, D = q.shape
        grads = flash_attention_bwd_reference(
            *(_flat(x) for x in (q, k, v, o)), lse, _flat(do), t_valid)
        return tuple(g.view(B, H, T, D).permute(0, 2, 1, 3).contiguous()
                     for g in grads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dt = q.dtype
    qs = (q.float() * scale).to(dt).float()
    kf, vf, dof = k.float(), v.float(), do.float()
    logits = torch.matmul(qs, kf.transpose(-1, -2))
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(col >= t_valid, -1e30)
    p = torch.exp(logits - lse[..., None])
    delta = flash_attention_bwd_delta(o, do)[..., None]
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    p_lo, ds_lo = p.to(dt).float(), ds.to(dt).float()
    dv = torch.matmul(p_lo.transpose(-1, -2), dof)
    dq = torch.matmul(ds_lo, kf) * scale
    dk = torch.matmul(ds_lo.transpose(-1, -2), q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, t_valid: int):
    """The backward kernels' wrapper: q, k, v, o, do of one shape, [BH, T, D]
    or [B, T, H, D], lse [BH, T] fp32 -> (dq, dk, dv) of that shape,
    contiguous, in q's dtype.

    CUDA tensors launch `occm_flash_attn_bwd_dq` (which computes
    δ = rowsum(dO ⊙ O) in fp32, as the TPU wrapper does outside its
    kernels, and writes it to a [BH, T] buffer) and then
    `occm_flash_attn_bwd_dkv` (which reads it) on the current stream: bf16,
    D a multiple of 8 from 8 to 256, every input read through its strides
    ([B, T, H, D] views of the projections' output need no copy), two
    device launches and nothing else. At D other than 64 and 256 the dq
    kernel also writes bf16(q * scale) to a [B, T, H, D] scratch tensor
    that the dk/dv kernel reads. Above D 256 the pair is
    `occm_flash_attn_panel_bwd_dq` and `_dkv`, which need no scratch (each
    folds the scale into the q panels it streams). fp32 at
    TF32_BWD_HEAD_DIMS launches the
    3xTF32 pair the same way (`occm_flash_attn_3xtf32_bwd_dq`, then
    `_dkv`), and any other dtype and D that `cuda_bwd_route` takes the
    generic pair (`occm_flash_attn_generic_bwd_dq`, then `_dkv`); both read
    any strides. CPU tensors take the plain version."""
    tensors = (q, k, v, o, do)
    if len({x.device for x in tensors + (lse,)}) != 1:
        raise ValueError("flash attention backward: inputs on different "
                         "devices")
    if q.dim() not in (3, 4) or any(x.shape != q.shape for x in tensors):
        raise ValueError(
            f"expected q, k, v, o, do of one shape [BH, T, D] or "
            f"[B, T, H, D], got {[tuple(x.shape) for x in tensors]}")
    four_d = q.dim() == 4
    B, T, H, D = q.shape if four_d else (q.shape[0], q.shape[1], 1,
                                         q.shape[2])
    if lse.shape != (B * H, T) or lse.dtype != torch.float32:
        raise ValueError(f"expected lse [BH, T] = [{B * H}, {T}] fp32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not 1 <= t_valid <= T:
        raise ValueError(f"t_valid={t_valid} outside [1, {T}]")
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, t_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    route = _route([x.dtype for x in tensors], D, backward=True)
    if not lse.is_contiguous():
        raise ValueError("the CUDA kernels take a contiguous lse")
    if route == "generic":
        return _generic_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D)
    if route == "3xtf32":
        return _tf32_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D)
    if D > WGMMA_MAX_SINGLE_PANEL:
        return _panel_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D)
    return _wgmma_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D,
                      int(D not in LOGITS_SCALE_HEAD_DIMS))


def _wgmma_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D, fold):
    """`occm_flash_attn_bwd_dq` then `_dkv` on the current stream, the scale
    folded into q (fold 1: the dq kernel writes bf16(q * scale) to a
    [B, T, H, D] scratch tensor that the dk/dv kernel reads) or on the fp32
    logits (fold 0, at LOGITS_SCALE_HEAD_DIMS only, where both give the
    same bits); raises ValueError for strides their maps cannot read."""
    global BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    global OTHER_D_BWD_DQ_LAUNCHES, OTHER_D_BWD_DKV_LAUNCHES
    (qp, *qs), (kp, *ks), (vp, *vs), (op, *os_), (dop, *dos) = (
        _launch_args(x, four_d) for x in (q, k, v, o, do))

    from occm_tpu_torch.ops import _build

    lib = _build.load()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    q_scaled = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
                if fold else None)
    qs_ptr = None if q_scaled is None else q_scaled.data_ptr()
    stream = _build.raw_stream(q.device)
    scale = 1.0 / math.sqrt(D)
    with _build.on_device(q.device):
        err = lib.occm_flash_attn_bwd_dq(
            qp, kp, vp, op, dop, lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), qs_ptr, B, H, T, t_valid, D, *qs, *ks, *vs, *os_,
            *dos, scale, stream, fold)
        if err != 0:
            raise RuntimeError(f"occm_flash_attn_bwd_dq failed: error {err}")
        if D == 64:
            BWD_DQ_LAUNCHES += 1
        else:
            OTHER_D_BWD_DQ_LAUNCHES += 1
        err = lib.occm_flash_attn_bwd_dkv(
            qp, kp, vp, dop, lse.data_ptr(), delta.data_ptr(), qs_ptr,
            dk.data_ptr(), dv.data_ptr(), B, H, T, t_valid, D, *qs, *ks, *vs,
            *dos, scale, stream, fold)
        if err != 0:
            raise RuntimeError(f"occm_flash_attn_bwd_dkv failed: error {err}")
        if D == 64:
            BWD_DKV_LAUNCHES += 1
        else:
            OTHER_D_BWD_DKV_LAUNCHES += 1
    return dq, dk, dv


def _panel_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D):
    """`occm_flash_attn_panel_bwd_dq` then `_dkv` on the current stream;
    raises ValueError for strides their maps cannot read."""
    global PANEL_BWD_DQ_LAUNCHES, PANEL_BWD_DKV_LAUNCHES
    (qp, *qs), (kp, *ks), (vp, *vs), (op, *os_), (dop, *dos) = (
        _launch_args(x, four_d) for x in (q, k, v, o, do))

    from occm_tpu_torch.ops import _build

    lib = _build.load()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    stream = _build.raw_stream(q.device)
    scale = 1.0 / math.sqrt(D)
    with _build.on_device(q.device):
        err = lib.occm_flash_attn_panel_bwd_dq(
            qp, kp, vp, op, dop, lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, H, T, t_valid, D, *qs, *ks, *vs, *os_, *dos,
            scale, stream)
        if err != 0:
            raise RuntimeError(
                f"occm_flash_attn_panel_bwd_dq failed: error {err}")
        PANEL_BWD_DQ_LAUNCHES += 1
        err = lib.occm_flash_attn_panel_bwd_dkv(
            qp, kp, vp, dop, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, T, t_valid, D, *qs, *ks, *vs, *dos, scale,
            stream)
        if err != 0:
            raise RuntimeError(
                f"occm_flash_attn_panel_bwd_dkv failed: error {err}")
        PANEL_BWD_DKV_LAUNCHES += 1
    return dq, dk, dv


def _generic_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D):
    """`occm_flash_attn_generic_bwd_dq` then `_dkv` on the current stream."""
    global GENERIC_BWD_DQ_LAUNCHES, GENERIC_BWD_DKV_LAUNCHES
    from occm_tpu_torch.ops import _build

    lib = _build.load()
    (qp, *qs), (kp, *ks), (vp, *vs), (op, *os_), (dop, *dos) = (
        _strides4(x, four_d) for x in (q, k, v, o, do))
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    stream = _build.raw_stream(q.device)
    scale = 1.0 / math.sqrt(D)
    code = _DTYPE_CODE[q.dtype]
    with _build.on_device(q.device):
        err = lib.occm_flash_attn_generic_bwd_dq(
            qp, kp, vp, op, dop, lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), code, B, H, T, t_valid, D, *qs, *ks, *vs, *os_,
            *dos, scale, stream)
        if err != 0:
            raise RuntimeError(
                f"occm_flash_attn_generic_bwd_dq failed: error {err}")
        GENERIC_BWD_DQ_LAUNCHES += 1
        err = lib.occm_flash_attn_generic_bwd_dkv(
            qp, kp, vp, dop, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), code, B, H, T, t_valid, D, *qs, *ks, *vs, *dos,
            scale, stream)
        if err != 0:
            raise RuntimeError(
                f"occm_flash_attn_generic_bwd_dkv failed: error {err}")
        GENERIC_BWD_DKV_LAUNCHES += 1
    return dq, dk, dv


def _tf32_bwd(q, k, v, o, lse, do, t_valid, four_d, B, H, T, D):
    """`occm_flash_attn_3xtf32_bwd_dq` then `_dkv` on the current stream."""
    global TF32_BWD_DQ_LAUNCHES, TF32_BWD_DKV_LAUNCHES
    from occm_tpu_torch.ops import _build

    lib = _build.load()
    (qp, *qs), (kp, *ks), (vp, *vs), (op, *os_), (dop, *dos) = (
        _strides4(x, four_d) for x in (q, k, v, o, do))
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    stream = _build.raw_stream(q.device)
    scale = 1.0 / math.sqrt(D)
    with _build.on_device(q.device):
        err = lib.occm_flash_attn_3xtf32_bwd_dq(
            qp, kp, vp, op, dop, lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, H, T, t_valid, D, *qs, *ks, *vs, *os_, *dos,
            scale, stream)
        if err != 0:
            raise RuntimeError(
                f"occm_flash_attn_3xtf32_bwd_dq failed: error {err}")
        TF32_BWD_DQ_LAUNCHES += 1
        err = lib.occm_flash_attn_3xtf32_bwd_dkv(
            qp, kp, vp, dop, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, T, t_valid, D, *qs, *ks, *vs, *dos, scale,
            stream)
        if err != 0:
            raise RuntimeError(
                f"occm_flash_attn_3xtf32_bwd_dkv failed: error {err}")
        TF32_BWD_DKV_LAUNCHES += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """[B, T, H, D] attention with the kernels on both passes. The forward
    reads q, k, v where they lie and saves them with out and lse; the
    backward reads them, and dO, where they lie too, and returns the
    kernels' contiguous [B, T, H, D] gradients."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v, q.shape[1])
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        global BWD_DOUT_COPIES
        q, k, v, out, lse = ctx.saved_tensors
        # the wgmma route's TMA maps need 16-byte strides; the generic and
        # 3xTF32 routes read any dO where they lie
        if (dout.device.type == "cuda"
                and cuda_route(q.dtype, q.shape[-1]) == "wgmma"
                and not _tma_readable(dout, True)):
            dout = dout.clone(memory_format=torch.contiguous_format)
            BWD_DOUT_COPIES += 1
        return flash_attention_bwd(q, k, v, out, lse, dout, q.shape[1])


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Fused MHA: q, k, v [B, T, H, D] (unscaled q; any strides the kernel
    can read, such as views of the projections' output) -> out [B, T, H, D]
    contiguous, so out.reshape(B, T, H * D) is a view; differentiable in q,
    k and v."""
    return _FlashAttention.apply(q, k, v)


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain einsum attention, same signature and semantics as
    flash_attention: fp32 logits and softmax, probabilities cast to v's
    dtype."""
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * (1.0 / math.sqrt(D)), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
