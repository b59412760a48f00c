"""The port's flash-attention op against the JAX Pallas kernels.

On the CPU the port's wrapper runs the kernel's plain version
(`flash_attention_reference`); the JAX side runs its Pallas kernels in
interpret mode, as tests/test_attention.py does. T=201 takes the whole-T
kernel (`_fwd_kernel`), T=600 and T=1500 the blocked online-softmax kernel
(`_blocked_fwd_kernel`); the tolerances are tests/test_attention.py's. The
CUDA kernel itself is held against the same plain version on the card by
chip_smoke.py.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occm_tpu.ops import attention as jax_attention
from occm_tpu_torch.ops import attention
from occm_tpu_torch.utils.device import resolve_device

D = 64


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * 0.5
            for _ in range(3)]


@pytest.mark.parametrize("T, B, H, atol", [
    (201, 2, 4, 2e-5),    # whole-T route
    (600, 2, 2, 3e-5),    # blocked route, blk 1024
    (1500, 1, 2, 3e-5),   # blocked route, blk 512, three kv tiles
])
def test_flash_attention_matches_pallas_kernel(T, B, H, atol):
    q, k, v = _qkv((B, T, H, 64))
    want = np.asarray(jax_attention.flash_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True))
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (B, T, H, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_lse_matches_blocked_kernel():
    """The second output, [BH, T] fp32, is the blocked kernel's lse
    without its 128-lane replication."""
    B, H, T, D = 1, 2, 600, 64
    q, k, v = _qkv((B, H, T, D), seed=1)
    Tp = 1024  # _pick_blk(600) pads to one 1024 tile
    pad = ((0, 0), (0, 0), (0, Tp - T), (0, 0))
    _, lse = jax_attention._run_blocked_fwd(
        *(jnp.pad(jnp.asarray(x), pad) for x in (q, k, v)), T,
        1.0 / math.sqrt(D), True)
    want = np.asarray(lse)[:, :T, 0]
    _, got = attention.flash_attention_fwd(
        *(torch.from_numpy(x.reshape(B * H, T, D)) for x in (q, k, v)), T)
    assert got.dtype == torch.float32 and got.shape == (B * H, T)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_reference_attention_matches_jax():
    q, k, v = _qkv((2, 97, 4, 64), seed=2)
    want = np.asarray(jax_attention.reference_attention(
        *map(jnp.asarray, (q, k, v))))
    got = attention.reference_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_keys_past_t_valid_are_masked():
    """Whatever sits in the keys and values past t_valid leaves the output
    unchanged, and lse equals the unpadded one."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((3, 80, 64), seed=3))
    out, lse = attention.flash_attention_fwd(q, k, v, 50)
    k2, v2 = k.clone(), v.clone()
    k2[:, 50:] = 1e3
    v2[:, 50:] = -7.0
    out2, lse2 = attention.flash_attention_fwd(q, k2, v2, 50)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)
    logits = (q @ k[:, :50].transpose(1, 2)) * 0.125
    want = torch.softmax(logits, dim=-1) @ v[:, :50]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1),
                               rtol=1e-5, atol=1e-5)


def test_plain_version_keeps_the_kernels_bf16_casts():
    """bf16 inputs: q is scaled in fp32 then cast to bf16 and P is cast to
    bf16 before P·V, exactly as the Pallas kernels do."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv((2, 40, 64), seed=4))
    out, lse = attention.flash_attention_reference(q, k, v, 40)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    qs = (q.float() * 0.125).to(torch.bfloat16).float()
    logits = qs @ k.float().transpose(1, 2)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    want = ((p.to(torch.bfloat16).float() @ v.float())
            / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 33, 2, 64), seed=5))
    before = attention.LAUNCHES
    out = attention.flash_attention(q, k, v)
    assert attention.LAUNCHES == before
    want = attention.reference_attention(q, k, v)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    """The port's entry points resolve their device through resolve_device:
    CUDA unless the caller names the CPU, and an error (never a silent CPU
    run) when no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("bad", ["shape", "t_valid", "device"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v = (torch.zeros(2, 16, 64) for _ in range(3))
    t_valid = 16
    if bad == "shape":
        k = torch.zeros(2, 17, 64)
    elif bad == "t_valid":
        t_valid = 0
    else:
        q, k, v = (x.to("meta") for x in (q, k, v))
    with pytest.raises(ValueError):
        attention.flash_attention_fwd(q, k, v, t_valid)


@pytest.mark.parametrize("T, B, H", [
    (201, 2, 2),   # whole-T route: _bwd_kernel
    (600, 1, 2),   # blocked route: _blocked_dq_kernel, _blocked_dkv_kernel
    (700, 1, 2),   # blocked route, ragged T in one 1024 tile
])
def test_flash_attention_gradients_match_pallas_kernels(T, B, H):
    """The port's autograd Function (on the CPU: the plain backward fed by
    the forward's lse) against jax.vjp of the Pallas kernels in interpret
    mode, fp32; tolerances of tests/test_attention.py."""
    import jax

    q, k, v = _qkv((B, T, H, 64), seed=10 + T)
    g = np.random.default_rng(T).normal(size=(B, T, H, 64)).astype(
        np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_attention.flash_attention(a, b, c,
                                                      interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.flash_attention(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (B, T, H, 64) and a.is_contiguous(), name
        assert a.reshape(B, T, H * 64).data_ptr() == a.data_ptr(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("t_valid", [53, 64])
def test_plain_backward_matches_autograd_of_plain_forward(t_valid):
    """flash_attention_bwd_reference (P from the saved lse, δ = rowsum(dO ⊙
    O)) equals torch autograd through flash_attention_reference, keys past
    t_valid included (they get zero gradient)."""
    q, k, v = (torch.from_numpy(x).double().float().requires_grad_()
               for x in _qkv((3, 64, 64), seed=11))
    out, lse = attention.flash_attention_reference(q, k, v, t_valid)
    do = torch.from_numpy(np.random.default_rng(12).normal(
        size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = attention.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), do,
        t_valid)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert torch.count_nonzero(got[1][:, t_valid:]) == 0
    assert torch.count_nonzero(got[2][:, t_valid:]) == 0


def test_backward_on_cpu_takes_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv((1, 40, 2, 64), seed=13))
    before = (attention.LAUNCHES, attention.BWD_DQ_LAUNCHES,
              attention.BWD_DKV_LAUNCHES)
    attention.flash_attention(q, k, v).sum().backward()
    assert all(x.grad is not None for x in (q, k, v))
    assert (attention.LAUNCHES, attention.BWD_DQ_LAUNCHES,
            attention.BWD_DKV_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["lse_shape", "shape", "device"])
def test_backward_wrapper_rejects_bad_arguments(bad):
    q, k, v, o, do = (torch.zeros(2, 16, 64) for _ in range(5))
    lse = torch.zeros(2, 16)
    if bad == "lse_shape":
        lse = torch.zeros(2, 15)
    elif bad == "shape":
        do = torch.zeros(2, 16, 32)
    else:
        q, k, v, o, do, lse = (x.to("meta") for x in (q, k, v, o, do, lse))
    with pytest.raises(ValueError):
        attention.flash_attention_bwd(q, k, v, o, lse, do, 16)


def _fused_projection(B, T, H, seed):
    """One [B, T, 3, H, D] projection output, as a fused qkv linear leaves
    it; q, k and v are [B, T, H, D] views of it (not contiguous)."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, 3, H, D)).astype(np.float32) * 0.5


@pytest.mark.parametrize("T, B, H", [
    (201, 2, 2),   # whole-T route: _fwd_kernel, _bwd_kernel
    (600, 1, 2),   # blocked route: _blocked_fwd_kernel, dq and dk/dv
])
def test_flash_attention_on_strided_views_matches_pallas_kernels(T, B, H):
    """flash_attention on [B, T, H, D] views of one projection output (the
    layout the CUDA kernel reads in place) against the Pallas kernels in
    interpret mode: forward at atol 2e-5, gradients of the projection
    output at atol 5e-4 / rtol 1e-3 (tests/test_attention.py's)."""
    import jax

    qkv = _fused_projection(B, T, H, seed=20 + T)
    g = np.random.default_rng(T + 1).normal(size=(B, T, H, D)).astype(
        np.float32)
    want, vjp = jax.vjp(
        lambda a, b, c: jax_attention.flash_attention(a, b, c,
                                                      interpret=True),
        *(jnp.asarray(qkv[:, :, i]) for i in range(3)))
    want_grads = vjp(jnp.asarray(g))

    base = torch.from_numpy(qkv).requires_grad_()
    q, k, v = base.unbind(2)
    assert not q.is_contiguous() and q.stride() == (T * 3 * H * D,
                                                    3 * H * D, D, 1)
    out = attention.flash_attention(q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    (grad,) = torch.autograd.grad(out, base, torch.from_numpy(g))
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(grad[:, :, i].numpy(),
                                   np.asarray(want_grads[i]), atol=5e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("layout", ["contiguous", "views"])
def test_output_reshapes_to_the_model_width_without_a_copy(layout):
    """out is [B, T, H, D] contiguous whatever q, k and v's strides, so the
    model's out.reshape(B, T, H * D) is a view."""
    B, T, H = 2, 37, 3
    qkv = torch.from_numpy(_fused_projection(B, T, H, seed=21))
    q, k, v = ((x.contiguous() for x in qkv.unbind(2))
               if layout == "contiguous" else qkv.unbind(2))
    out = attention.flash_attention(q, k, v)
    assert out.shape == (B, T, H, D) and out.is_contiguous()
    flat = out.reshape(B, T, H * D)
    assert flat.data_ptr() == out.data_ptr() and flat._base is out
    torch.testing.assert_close(
        out, attention.reference_attention(q, k, v), rtol=1e-5, atol=1e-5)


def _plain_with_scale_on_logits(q, k, v, t_valid):
    """flash_attention_reference with the scale applied to the fp32 logits
    of the unscaled q, as the CUDA kernel applies it."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    col = torch.arange(logits.shape[-1])
    logits = logits.masked_fill(col >= t_valid, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]


@pytest.mark.parametrize("dtype, T, t_valid", [
    (torch.bfloat16, 201, 201), (torch.bfloat16, 299, 250),
    (torch.bfloat16, 600, 600), (torch.float32, 130, 97)])
def test_scale_on_logits_is_bit_identical_for_head_dim_64(dtype, T, t_valid):
    """For D = 64 the scale is 2^-3: bf16(q * 2^-3) = bf16(q) * 2^-3 and
    every fp32 partial sum of q k^T scales exactly, so moving the scale
    from q (the TPU kernels and the plain version) onto the fp32 logits
    (the CUDA kernel) changes no bit of out or lse."""
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv((4, T, D), seed=30 + T))
    got = _plain_with_scale_on_logits(q, k, v, t_valid)
    want = attention.flash_attention_reference(q, k, v, t_valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_launch_args_read_strided_views_and_reject_what_tma_cannot():
    """The strides the kernel's 4-d TMA maps get: a fused projection's
    views keep theirs, [BH, T, D] is B = BH, H = 1 (the H stride given as
    D), and a stride or offset off the 16-byte grid raises."""
    B, T, H = 2, 5, 3
    qkv = torch.zeros((B, T, 3, H, D), dtype=torch.bfloat16)
    q = qkv[:, :, 0]
    assert attention._launch_args(q, True)[1:] == (T * 3 * H * D, 3 * H * D,
                                                   D)
    flat = torch.zeros((B * H, T, D), dtype=torch.bfloat16)
    assert attention._launch_args(flat, False)[1:] == (T * D, D, D)
    wide = torch.zeros((B, T, H, D + 4), dtype=torch.bfloat16)[..., :D]
    buf = torch.zeros(B * T * H * D + 4, dtype=torch.bfloat16)
    shifted = buf[4:].view(B, T, H, D)
    for bad in (wide, shifted, qkv.transpose(-1, -2)[:, :, 0]):
        with pytest.raises(ValueError, match="16-byte"):
            attention._launch_args(bad, True)


def _bwd_inputs(B, T, H, dtype, seed):
    """q, k, v as [B, T, H, D] views of one [B, T, 3 * H * D] projection
    buffer, out and lse from the forward, and dO, all in `dtype`."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(
        rng.normal(size=(B, T, 3 * H * D)).astype(np.float32)).to(dtype)
    q, k, v = qkv.view(B, T, 3, H, D).unbind(2)
    out, lse = attention.flash_attention_fwd(q, k, v, T)
    do = torch.from_numpy(
        rng.normal(size=(B, T, H, D)).astype(np.float32)).to(dtype)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["contiguous", "views"])
def test_backward_on_b_t_h_d_gives_the_bits_of_bh_t_d(layout, dtype):
    """The backward wrapper on [B, T, H, D] (contiguous, or strided views of
    a [B, T, 3 * H * D] buffer, as the kernels read them in place) returns
    contiguous [B, T, H, D] gradients with the same bits as on [BH, T, D],
    the case B = BH, H = 1."""
    B, T, H = 2, 70, 3
    q, k, v, out, lse, do = _bwd_inputs(B, T, H, dtype, seed=40)
    if layout == "contiguous":
        q, k, v = (x.contiguous() for x in (q, k, v))
    else:
        assert not q.is_contiguous()
    got = attention.flash_attention_bwd(q, k, v, out, lse, do, T)

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()

    want = attention.flash_attention_bwd(
        *(flat(x) for x in (q, k, v, out)), lse, flat(do), T)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (B, T, H, D) and a.is_contiguous(), name
        assert a.dtype == dtype, name
        assert torch.equal(flat(a), b), name


def test_backward_delta_is_the_fp32_rowsum_in_the_layout_of_lse():
    """δ = rowsum(dO ⊙ O) in fp32, [BH, T] rows ordered as lse's (b, h), on
    [B, T, H, D] and on [BH, T, D]."""
    B, T, H = 2, 33, 3
    _, _, _, out, lse, do = _bwd_inputs(B, T, H, torch.bfloat16, seed=41)
    delta = attention.flash_attention_bwd_delta(out, do)
    assert delta.dtype == torch.float32 and delta.shape == lse.shape
    want = (do.double() * out.double()).sum(-1).permute(0, 2, 1).reshape(
        B * H, T)
    torch.testing.assert_close(delta, want.float(), rtol=1e-6, atol=1e-6)
    flat = attention.flash_attention_bwd_delta(
        *(x.permute(0, 2, 1, 3).reshape(B * H, T, D) for x in (out, do)))
    assert torch.equal(flat, delta)


@pytest.mark.parametrize("dtype, head_dim, route", [
    (torch.bfloat16, 64, "wgmma"), (torch.float32, 64, "3xtf32"),
    (torch.bfloat16, 16, "wgmma"), (torch.float32, 16, "3xtf32"),
    (torch.float16, 64, None), (torch.bfloat16, 1, "generic"),
    (torch.float32, 256, "generic"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 257, "generic"), (torch.float32, 0, None)])
def test_cuda_kernel_takes_only_bf16_with_head_dim_64(dtype, head_dim,
                                                      route):
    """The wgmma kernels take only bf16, at head dims that are multiples
    of 8 (64, 16 and 256 here); the 3xTF32 forward takes fp32 at the
    head dims of its table (64 and 16 here), the generic kernels fp32 at
    every other head dim from 1 up and bf16 at the others (257 here);
    nothing takes fp16 or a head dim below 1."""
    assert attention.cuda_route(dtype, head_dim) == route
    assert attention.cuda_kernel_takes(dtype, head_dim) is (route is not None)


@pytest.mark.parametrize("dtype, head_dim, route", [
    *((torch.bfloat16, d, "wgmma")
      for d in (8, 16, 24, 32, 48, 64, 80, 120, 128, 136, 192, 200, 248,
                256)),
    *((torch.bfloat16, d, "generic") for d in (1, 7, 12, 252)),
    *((torch.float32, d, "generic") for d in (1, 7, 136, 256)),
    *((torch.float32, d, "3xtf32") for d in (8, 16, 64, 80, 120, 128)),
    (torch.bfloat16, 257, "generic"), (torch.float32, 257, "generic"),
    (torch.bfloat16, 264, "wgmma")])
def test_cuda_route_table(dtype, head_dim, route):
    """The wgmma kernels (csrc/flash_attn_fwd.cu, flash_attn_bwd.cu) take
    bf16 at every head dim that is a multiple of 8 from 8 to 256, one
    instance for each round_up(D, 16), and the panel kernels
    (csrc/flash_attn_panel.cu) the multiples of 8 above (264 here), on the
    same route; the 3xTF32 forward (csrc/flash_attn_fwd_3xtf32.cu) takes
    fp32 at the head dims of TF32_FWD_HEAD_DIMS; the generic kernels keep
    fp32 at every other D and bf16 at a D that is not a multiple of 8,
    above 256 too (257 here)."""
    assert attention.cuda_route(dtype, head_dim) == route
    if dtype == torch.bfloat16:
        assert (head_dim in attention.WGMMA_HEAD_DIMS) is (route == "wgmma")


def test_backward_copies_only_a_dout_its_maps_cannot_read():
    """dO of `out.sum()` is an expanded stride-0 tensor: the TMA maps cannot
    read it (on a card the backward makes one counted contiguous copy); a
    CPU backward takes it as it is and counts no copy."""
    B, T, H = 1, 24, 2
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv((B, T, H, D), seed=42))
    out = attention.flash_attention(q, k, v)
    expanded = torch.ones(()).expand(out.shape)
    assert not attention._tma_readable(expanded, True)
    assert attention._tma_readable(expanded.contiguous(), True)
    before = attention.BWD_DOUT_COPIES
    out.sum().backward()
    assert attention.BWD_DOUT_COPIES == before
    want = torch.autograd.grad(
        attention.reference_attention(q, k, v).sum(), (q, k, v))
    for x, w in zip((q, k, v), want):
        assert x.grad.is_contiguous()
        torch.testing.assert_close(x.grad, w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- coverage:
# fp32 and bf16 at head dims other than 64 (the generic CUDA kernels' route;
# on the CPU their plain version) against the Pallas kernels in interpret
# mode, which run their dots in q's dtype at any head dim. fp32 at the JAX
# suite's tolerances (tests/test_attention.py: forward atol 2e-5, 3e-5 on
# the blocked route; gradients atol 5e-4 / rtol 1e-3). bf16 within the
# bounds of the kernels' bf16 checks: the whole-T TPU kernel normalises P
# before its bf16 cast and the port after (one rounding of P, relative
# 2^-9), and the bf16 outputs round once more (2^-8 relative, a flip of it
# 2^-7 of the largest |value|): forward 2^-7 of the largest |out|;
# gradients 2^-6 of the largest |value| of each (chip_smoke.py's
# BWD_RTOL_OF_MAX: P and dS rounded to bf16 before their products, and the
# whole-T TPU backward takes delta from its own fp32 P).
COVERAGE_DIMS = (16, 32, 80, 128, 136, 192, 256)
BF16_OUT_RTOL_OF_MAX = 2.0 ** -7
BF16_GRAD_RTOL_OF_MAX = 2.0 ** -6


@pytest.mark.parametrize("T, B, H", [(201, 2, 2), (600, 1, 2)],
                         ids=["whole_T", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", COVERAGE_DIMS)
def test_coverage_dtype_and_head_dim_match_pallas_kernels(head_dim, dtype,
                                                          T, B, H):
    """Forward and gradients of the port's flash attention at fp32 / bf16
    and D in {16, 32, 80, 128} against jax.vjp of the Pallas kernels in
    interpret mode, on the whole-T route (T <= 512) and the blocked one."""
    import jax

    q, k, v = _qkv((B, T, H, head_dim), seed=50 + head_dim)
    g = np.random.default_rng(head_dim + T).normal(
        size=(B, T, H, head_dim)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want, vjp = jax.vjp(
        lambda a, b, c: jax_attention.flash_attention(a, b, c,
                                                      interpret=True),
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g).astype(jdt))

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = attention.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and out.shape == (B, T, H, head_dim)

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32))

    got = [out.detach().float().numpy()] + [x.float().numpy() for x in grads]
    ref = [f32(want)] + [f32(x) for x in want_grads]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        if dtype == "float32":
            if name == "out":
                atol = 2e-5 if T <= 512 else 3e-5
                np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3,
                                           err_msg=name)
        else:
            bound = (BF16_OUT_RTOL_OF_MAX if name == "out"
                     else BF16_GRAD_RTOL_OF_MAX) * np.abs(b).max()
            err = np.abs(a - b).max()
            assert err <= bound, f"{name}: {err} > {bound}"


@pytest.mark.parametrize("head_dim", [32, 80, 128])
def test_folding_the_scale_before_the_bf16_cast_differs_from_scaling_logits(
        head_dim):
    """For D = 32, 80, 128 the scale 1/sqrt(D) is not a power of two, so
    bf16(q * scale) is not bf16(q) * scale: the generic kernels fold the
    scale into q before the cast, as the TPU kernels and the plain version
    do, and scaling the fp32 logits (what the D = 64 wgmma kernels may do)
    would give other bits. The plain version's logits are those of the
    scale-folded bf16 q."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv((4, 96, head_dim), seed=60 + head_dim))
    fold = attention.flash_attention_reference(q, k, v, 96)
    logits = _plain_with_scale_on_logits(q, k, v, 96)
    assert not torch.equal(fold[1], logits[1])
    assert not torch.equal(fold[0], logits[0])
    scale = 1.0 / math.sqrt(head_dim)
    qs = (q.float() * scale).to(torch.bfloat16).float()
    want = torch.logsumexp(qs @ k.float().transpose(1, 2), dim=-1)
    torch.testing.assert_close(fold[1], want, rtol=1e-5, atol=1e-5)


def _cuda_patched(monkeypatch):
    """Every tensor reports cuda:0; the plain versions raise if reached and
    the library's load raises Built: a wrapper that routes a CUDA tensor
    to a kernel reaches the build, never the plain version."""
    from occm_tpu_torch.ops import _build

    class Built(Exception):
        pass

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    def load():
        raise Built

    monkeypatch.setattr(attention, "flash_attention_reference", plain)
    monkeypatch.setattr(attention, "flash_attention_bwd_reference", plain)
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    return Built


@pytest.mark.parametrize("dtype, head_dim, reaches", [
    (torch.float32, 64, "3xtf32"), (torch.float32, 16, "3xtf32"),
    (torch.bfloat16, 80, "wgmma"), (torch.float32, 256, "generic"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 136, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 0, None),
    (torch.float32, 257, "generic"), (torch.float16, 64, None),
    (torch.float16, 16, None)])
def test_cuda_wrappers_route_or_refuse(monkeypatch, dtype, head_dim,
                                       reaches):
    """On a CUDA tensor the forward wrapper takes the route `cuda_route`
    names (fp32 at D 64 and 16: the 3xTF32 forward, whose TMA maps read
    these contiguous tensors) and the backward wrapper the one
    `cuda_bwd_route` names (fp32 at D 64 and 16: the 3xTF32 pair), and
    both go on to the build (the generic kernels and the 3xTF32 backward
    read any strides, so the views need no check; fp32 at D 257 takes the
    generic kernels' panels), or raise ValueError for what no route takes
    (D 0, fp16), before any build; a mixed-dtype call raises. Checked with
    the device test patched, as this host has no card."""
    T = 8
    q, k, v, o, do = (torch.zeros((2, T, 3, head_dim), dtype=dtype)
                      for _ in range(5))
    lse = torch.zeros((6, T))
    seen = []
    generic = {"fwd": attention._generic_fwd, "bwd": attention._generic_bwd,
               "3xtf32": attention._tf32_bwd}
    monkeypatch.setattr(attention, "_generic_fwd",
                        lambda *a: (seen.append("generic"), generic["fwd"](*a)))
    monkeypatch.setattr(attention, "_generic_bwd",
                        lambda *a: (seen.append("generic"), generic["bwd"](*a)))
    monkeypatch.setattr(attention, "_tf32_bwd",
                        lambda *a: (seen.append("3xtf32"), generic["3xtf32"](*a)))
    bwd_reaches = "3xtf32" if (dtype, head_dim) in (
        (torch.float32, 64), (torch.float32, 16)) else reaches
    Built = _cuda_patched(monkeypatch)
    if reaches is None:
        with pytest.raises(ValueError, match="of 1 or more"):
            attention.flash_attention_fwd(q, k, v, T)
        with pytest.raises(ValueError, match="of 1 or more"):
            attention.flash_attention_bwd(q, k, v, o, lse, do, T)
        return
    with pytest.raises(Built):
        attention.flash_attention_fwd(q, k, v, T)
    with pytest.raises(Built):
        attention.flash_attention_bwd(q, k, v, o, lse, do, T)
    # the wgmma and 3xTF32 forwards go to the build from the wrapper itself
    assert seen == ([reaches] if reaches == "generic" else []) + (
        [bwd_reaches] if bwd_reaches in ("generic", "3xtf32") else [])
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError, match="one dtype"):
        attention.flash_attention_fwd(q, k, v.to(other), T)


def test_generic_launch_args_read_any_strides():
    """The generic kernels get (ptr, sb, st, sh, sd) of any view: a fused
    projection's strided views, [BH, T, D] as B = BH, H = 1, and an
    expanded dO (all strides 0), which the wgmma route would copy."""
    B, T, H, Dh = 2, 5, 3, 16
    qkv = torch.zeros((B, T, 3, H, Dh))
    assert attention._strides4(qkv[:, :, 0], True)[1:] == (
        T * 3 * H * Dh, 3 * H * Dh, Dh, 1)
    flat = torch.zeros((B * H, T, Dh))
    assert attention._strides4(flat, False)[1:] == (T * Dh, Dh, Dh, 1)
    expanded = torch.ones(()).expand(B, T, H, Dh)
    assert attention._strides4(expanded, True)[1:] == (0, 0, 0, 0)


@pytest.mark.parametrize("head_dim", [64, 80, 136, 256])
def test_wgmma_launch_args_read_views_in_place_and_copy_an_expanded_dout(
        monkeypatch, head_dim):
    """On the wgmma route (patched to a recording library, as this host has
    no card) the forward and backward read strided [B, T, H, D] views of a
    fused projection in place: each gets the view's pointer and (sb, st,
    sh), the head dim, 1/sqrt(D) and whether to fold it into q. At D 80 and
    136 the scale is folded: the backward hands the dq kernel a
    [B, T, H, D] scratch tensor for bf16(q * scale) and the dk/dv kernel
    the same one; at D 64 and 256 (scales 2^-3 and 2^-4) the logits are
    scaled and there is none. Off D 64 the launches count apart
    (OTHER_D_*). Through autograd an expanded dO (of out.sum()) is copied
    once, contiguous, and the copy's strides reach the kernels."""
    from occm_tpu_torch.ops import _build

    B, T, H = 2, 9, 3
    calls = {}

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls[name] = args
                return 0
            return launch

    cpu_empty = torch.empty
    monkeypatch.setattr(_build, "load", Lib)
    monkeypatch.setattr(_build, "raw_stream", lambda device: 7)
    monkeypatch.setattr(_build, "on_device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        cpu_empty(*a, **kw))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    qkv = torch.zeros((B, T, 3, H, head_dim), dtype=torch.bfloat16)
    q, k, v = (x.detach().requires_grad_() for x in qkv.unbind(2))
    views = (T * 3 * H * head_dim, 3 * H * head_dim, head_dim)
    assert q.stride()[:3] == views and not q.is_contiguous()
    before = {n: getattr(attention, n) for n in (
        "LAUNCHES", "OTHER_D_LAUNCHES", "BWD_DQ_LAUNCHES",
        "OTHER_D_BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES",
        "OTHER_D_BWD_DKV_LAUNCHES", "BWD_DOUT_COPIES")}
    out = attention.flash_attention(q, k, v)
    fwd = calls["occm_flash_attn_fwd"]
    assert fwd[:3] == tuple(x.data_ptr() for x in (q, k, v))
    assert fwd[5:10] == (B, H, T, T, head_dim)
    assert fwd[10:19] == views * 3
    fold = int(head_dim not in (64, 256))
    assert fwd[19] == 1.0 / math.sqrt(head_dim) and fwd[20] == 7
    assert fwd[21:] == (fold,)
    out.sum().backward()
    dq_args, dkv_args = (calls["occm_flash_attn_bwd_dq"],
                         calls["occm_flash_attn_bwd_dkv"])
    contiguous = (T * H * head_dim, H * head_dim, head_dim)
    # q, k, v and out (contiguous) read where they lie; dO a copy
    assert dq_args[:3] == fwd[:3] and dq_args[9:14] == (B, H, T, T, head_dim)
    assert dq_args[14:23] == views * 3
    assert dq_args[23:29] == contiguous * 2
    assert dkv_args[:3] == fwd[:3] and dkv_args[9:14] == dq_args[9:14]
    assert dkv_args[14:26] == views * 3 + contiguous
    assert dq_args[4] == dkv_args[3] and dq_args[4] != out.data_ptr()
    scratch = dq_args[8]
    assert dkv_args[6] == scratch
    assert (scratch is None) == (not fold)
    assert dq_args[29:] == dkv_args[26:] == (fwd[19], 7, fold)
    other = head_dim != 64
    after = {n: getattr(attention, n) - b for n, b in before.items()}
    assert after == {"LAUNCHES": int(not other), "OTHER_D_LAUNCHES": int(other),
                     "BWD_DQ_LAUNCHES": int(not other),
                     "OTHER_D_BWD_DQ_LAUNCHES": int(other),
                     "BWD_DKV_LAUNCHES": int(not other),
                     "OTHER_D_BWD_DKV_LAUNCHES": int(other),
                     "BWD_DOUT_COPIES": 1}
    for x in (q, k, v):
        assert x.grad.shape == (B, T, H, head_dim) and x.grad.is_contiguous()
