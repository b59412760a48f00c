"""The port's fp32 tensor-core kernels on the CPU: the 3xTF32 attention
forward (csrc/flash_attn_fwd_3xtf32.cu) and backward
(csrc/flash_attn_bwd_3xtf32_dq.cu, _dkv.cu) and fused FFN
(csrc/ffn_fwd_3xtf32.cu).

The kernels run only on the card (chip_smoke.py phase 20 holds them
against their plain versions there). Here: the route tables, the launch
arguments and counters of the wrappers through a recording library (and
the strides the forward's TMA maps refuse), the auto threshold of the
3xTF32 route, and a plain fp32 emulation of the 3xTF32 split showing that
the
design meets the card's gates (COVERAGE_F32_RTOL_OF_MAX = 1e-5 for the
attention backward, FFN_F32_RTOL_OF_MAX = 1e-4 for the FFN) at the
model's shapes, where one TF32 product alone does not.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from occm_tpu_torch.classify import impl_select
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.ops import _build, attention, ffn

#: chip_smoke.py's bounds, relative to the largest |value| of the plain
#: fp32 result
ATTENTION_RTOL_OF_MAX = 1e-5
FFN_RTOL_OF_MAX = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The file's torch ops run on one thread: the suite's workers share
    the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("dtype, head_dim, route", [
    *((torch.float32, d, "3xtf32") for d in (8, 16, 24, 64, 80, 120, 128)),
    *((torch.float32, d, "generic") for d in (1, 7, 12, 20, 136, 256)),
    *((torch.bfloat16, d, "wgmma") for d in (8, 64, 80, 128, 136, 256)),
    *((torch.bfloat16, d, "generic") for d in (12, 252)),
    (torch.float32, 257, "generic"), (torch.bfloat16, 257, "generic"),
    (torch.float16, 64, None)])
def test_backward_route_table(dtype, head_dim, route):
    """The backward takes the 3xTF32 pair in fp32 at every head dim that is
    a multiple of 8 from 8 to 128, the generic pair at every other fp32 D
    (whichever kernel ran the forward; above 256 too), and the forward's
    route otherwise; the fp32 forward takes the 3xTF32 kernel at the head
    dims of its own table and the generic kernel at the others."""
    assert attention.cuda_bwd_route(dtype, head_dim) == route
    if dtype == torch.float32 and route is not None:
        assert attention.cuda_route(dtype, head_dim) == (
            "3xtf32" if head_dim in attention.TF32_FWD_HEAD_DIMS
            else "generic")


@pytest.mark.parametrize("dtype, head_dim", [
    *((torch.float32, d) for d in (1, 7, 8, 12, 16, 20, 24, 64, 80, 120,
                                   128, 136, 256)),
    *((torch.bfloat16, d) for d in (8, 12, 64, 136, 252, 256)),
    (torch.float32, 257), (torch.float16, 64)])
def test_forward_route_table(dtype, head_dim):
    """The fp32 forward takes the 3xTF32 kernel exactly at the head dims of
    TF32_FWD_HEAD_DIMS, which are multiples of 8 from 8 to 128 (its
    instances are round_up(D, 16) columns wide), and the generic kernel at
    every other D (257 too); bf16 keeps the wgmma route (multiples of 8)
    and the generic one; fp16 has no kernel."""
    assert set(attention.TF32_FWD_HEAD_DIMS) <= set(range(8, 129, 8))
    route = attention.cuda_route(dtype, head_dim)
    if dtype == torch.float32 and head_dim in attention.TF32_FWD_HEAD_DIMS:
        assert route == "3xtf32"
    elif dtype == torch.bfloat16 and head_dim % 8 == 0:
        assert route == "wgmma"
    elif dtype in (torch.float32, torch.bfloat16):
        assert route == "generic"
    else:
        assert route is None


# ------------------------------------------------- a recording library

@contextlib.contextmanager
def _recording_card(monkeypatch):
    """Every tensor reports cuda:0, torch.empty allocates on the CPU, and
    `_build.load` returns a library that records each entry point's
    arguments (by name, in call order) and returns 0."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls.append((name, args))
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
    yield calls


def _counts():
    return {n: getattr(attention, n) for n in (
        "TF32_FWD_LAUNCHES", "GENERIC_LAUNCHES", "GENERIC_BWD_DQ_LAUNCHES",
        "GENERIC_BWD_DKV_LAUNCHES", "TF32_BWD_DQ_LAUNCHES",
        "TF32_BWD_DKV_LAUNCHES", "BWD_DOUT_COPIES")}


@pytest.mark.parametrize("head_dim", [16, 64])
def test_3xtf32_backward_reads_views_and_an_expanded_dout_in_place(
        monkeypatch, head_dim):
    """fp32 attention through autograd on strided [B, T, H, D] views of a
    fused projection: the 3xTF32 forward, then the 3xTF32 pair, dq (with
    the δ buffer) then dk/dv, each given the views' pointers and their
    (sb, st, sh, sd), (B, H, T, t_valid, D), 1/sqrt(D) and the stream;
    the expanded dO of out.sum() reaches both kernels where it lies
    (strides 0, no copy); one launch counted on each of the three 3xTF32
    counters and none on the generic kernels'."""
    B, T, H = 2, 9, 3
    with _recording_card(monkeypatch) as calls:
        qkv = torch.zeros((B, T, 3, H, head_dim))
        q, k, v = (x.detach().requires_grad_() for x in qkv.unbind(2))
        before = _counts()
        out = attention.flash_attention(q, k, v)
        out.sum().backward()
    names = [name for name, _ in calls]
    assert names == ["occm_flash_attn_3xtf32_fwd",
                     "occm_flash_attn_3xtf32_bwd_dq",
                     "occm_flash_attn_3xtf32_bwd_dkv"]
    fwd, dq, dkv = (args for _, args in calls)
    views = (T * 3 * H * head_dim, 3 * H * head_dim, head_dim, 1)
    contiguous = (T * H * head_dim, H * head_dim, head_dim, 1)
    ptrs = tuple(x.data_ptr() for x in (q, k, v))
    scale = 1.0 / math.sqrt(head_dim)
    # dq: q, k, v, out, dout, lse, delta, dq; (B, H, T, t_valid, D);
    # strides of q, k, v, out, dout; scale; stream
    assert dq[:3] == ptrs and dq[3] == out.data_ptr()
    assert dq[5] == fwd[4]  # the forward's lse
    assert dq[8:13] == (B, H, T, T, head_dim)
    assert dq[13:33] == views * 3 + contiguous + (0, 0, 0, 0)
    assert dq[33] == scale and dq[34] == 7
    # dk/dv: q, k, v, dout, lse, delta, dk, dv; the same ints; strides of
    # q, k, v, dout
    assert dkv[:3] == ptrs and dkv[3] == dq[4] and dkv[4:6] == dq[5:7]
    assert dkv[8:13] == dq[8:13]
    assert dkv[13:29] == views * 3 + (0, 0, 0, 0)
    assert dkv[29] == scale and dkv[30] == 7
    assert dq[7] not in (dkv[6], dkv[7])
    after = {n: c - before[n] for n, c in _counts().items()}
    assert after == {"TF32_FWD_LAUNCHES": 1, "GENERIC_LAUNCHES": 0,
                     "GENERIC_BWD_DQ_LAUNCHES": 0,
                     "GENERIC_BWD_DKV_LAUNCHES": 0, "TF32_BWD_DQ_LAUNCHES": 1,
                     "TF32_BWD_DKV_LAUNCHES": 1, "BWD_DOUT_COPIES": 0}
    for x in (q, k, v):
        assert x.grad.shape == (B, T, H, head_dim) and x.grad.is_contiguous()


def test_3xtf32_backward_reads_bh_t_d_as_one_head(monkeypatch):
    """[B·H, T, D] inputs reach the pair as B = B·H, H = 1 with the head
    stride given as D, as the generic pair reads them."""
    BH, T, Dh = 6, 5, 24
    with _recording_card(monkeypatch) as calls:
        q, k, v, o, do = (torch.zeros((BH, T, Dh)) for _ in range(5))
        lse = torch.zeros((BH, T))
        grads = attention.flash_attention_bwd(q, k, v, o, lse, do, 4)
    (_, dq), (_, dkv) = calls
    assert dq[8:13] == (BH, 1, T, 4, Dh)
    assert dq[13:33] == (T * Dh, Dh, Dh, 1) * 5
    assert dkv[13:29] == (T * Dh, Dh, Dh, 1) * 4
    assert all(g.shape == (BH, T, Dh) for g in grads)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_3xtf32_forward_reads_projection_views_in_place(monkeypatch,
                                                        head_dim):
    """The forward wrapper on fp32 [B, T, H, D] views of a fused projection
    launches `occm_flash_attn_3xtf32_fwd` and nothing else: the views'
    pointers and (sb, st, sh), a fresh contiguous out and a [B·H, T] lse,
    (B, H, T, t_valid, D), 1/sqrt(D) and the stream; one launch on
    TF32_FWD_LAUNCHES, none on the generic forward's."""
    B, T, H = 2, 9, 3
    with _recording_card(monkeypatch) as calls:
        qkv = torch.zeros((B, T, 3, H, head_dim))
        q, k, v = qkv.unbind(2)
        before = _counts()
        out, lse = attention.flash_attention_fwd(q, k, v, 7)
    (name, args), = calls
    assert name == "occm_flash_attn_3xtf32_fwd"
    assert args[:3] == tuple(x.data_ptr() for x in (q, k, v))
    assert args[3:5] == (out.data_ptr(), lse.data_ptr())
    assert args[5:10] == (B, H, T, 7, head_dim)
    assert args[10:19] == (T * 3 * H * head_dim, 3 * H * head_dim,
                           head_dim) * 3
    assert args[19] == 1.0 / math.sqrt(head_dim) and args[20] == 7
    assert out.shape == (B, T, H, head_dim) and out.is_contiguous()
    assert lse.shape == (B * H, T) and lse.dtype == torch.float32
    after = {n: c - before[n] for n, c in _counts().items()}
    assert after["TF32_FWD_LAUNCHES"] == 1
    assert after["GENERIC_LAUNCHES"] == 0


def test_3xtf32_forward_reads_bh_t_d_as_one_head(monkeypatch):
    """[B·H, T, D] fp32 reaches the 3xTF32 forward as B = B·H, H = 1 with
    the head stride given as D."""
    BH, T, Dh = 6, 5, 24
    with _recording_card(monkeypatch) as calls:
        q, k, v = (torch.zeros((BH, T, Dh)) for _ in range(3))
        out, lse = attention.flash_attention_fwd(q, k, v, 4)
    (name, args), = calls
    assert name == "occm_flash_attn_3xtf32_fwd"
    assert args[5:10] == (BH, 1, T, 4, Dh)
    assert args[10:19] == (T * Dh, Dh, Dh) * 3
    assert out.shape == (BH, T, Dh) and lse.shape == (BH, T)


def test_3xtf32_forward_refuses_strides_its_maps_cannot_read(monkeypatch):
    """fp32 strides that are multiples of 4 elements (16 bytes) are read in
    place, though bf16's rule of 8 would refuse them; a stride off the
    16-byte grid, a base off it, or a head dim that is not contiguous
    raises ValueError before any launch, with no fallback to the generic
    kernel or the plain version."""
    B, T, H, Dh = 2, 5, 3, 16
    with _recording_card(monkeypatch) as calls:
        padded = torch.zeros((B, T, H, Dh + 4))[..., :Dh]
        attention.flash_attention_fwd(padded, padded, padded, T)
        assert [name for name, _ in calls] == ["occm_flash_attn_3xtf32_fwd"]
        assert calls[0][1][10:13] == (T * H * (Dh + 4), H * (Dh + 4),
                                      Dh + 4)
        wide = torch.zeros((B, T, H, Dh + 2))[..., :Dh]
        shifted = torch.zeros(B * T * H * Dh + 2)[2:].view(B, T, H, Dh)
        strided = torch.zeros((B, T, H, 2 * Dh))[..., ::2]
        before = _counts()
        for bad in (wide, shifted, strided):
            with pytest.raises(ValueError, match="16-byte"):
                attention.flash_attention_fwd(bad, bad, bad, T)
        assert len(calls) == 1 and _counts() == before


@pytest.mark.parametrize("cfg, route", [
    (XLSRConfig(dtype="float32"), "3xtf32"),          # D 64
    (XLSRConfig.tiny(), "3xtf32"),                    # D 16
    (dataclasses.replace(XLSRConfig.tiny(), encoder_embed_dim=48),
     "generic"),                                      # D 12
    (XLSRConfig(), "wgmma")])
def test_auto_threshold_follows_the_3xtf32_forward(cfg, route):
    """On a CUDA device auto's threshold for an fp32 model whose head dim
    the 3xTF32 forward takes is AUTO_TF32_MIN_SAMPLES; an fp32 head dim it
    does not take (12) keeps AUTO_GENERIC_MIN_SAMPLES, bf16 at D 64
    AUTO_FLASH_MIN_SAMPLES."""
    d = cfg.encoder_embed_dim // cfg.encoder_heads
    assert attention.cuda_route(getattr(torch, cfg.dtype), d) == route
    want = {"3xtf32": impl_select.AUTO_TF32_MIN_SAMPLES,
            "generic": impl_select.AUTO_GENERIC_MIN_SAMPLES,
            "wgmma": impl_select.AUTO_FLASH_MIN_SAMPLES}[route]
    assert impl_select.auto_flash_min_samples(cfg, "cuda") == want
    assert impl_select.auto_flash_min_samples(cfg, "cpu") == (
        impl_select.AUTO_FLASH_MIN_SAMPLES)


@pytest.mark.parametrize("d, f, kernel", [
    (64, 256, "occm_ffn_gemm_3xtf32"), (12, 20, "occm_ffn_gemm_3xtf32"),
    (10, 20, "occm_ffn_gemm_f32"), (12, 18, "occm_ffn_gemm_f32")])
def test_fp32_ffn_launches_the_3xtf32_kernel_where_d_and_f_are_multiples_of_4(
        monkeypatch, d, f, kernel):
    """fp32 fused_ffn with the weights as nn.Linear stores them: the
    3xTF32 kernel twice where D and F are multiples of 4 (fc1 + GELU into
    the [M, F] scratch, then fc2 reading it), each given the activation,
    fc1.weight / fc2.weight in place, (M, N, K) and the stream, counted
    once on TF32_LAUNCHES; the SIMT kernel twice at any other D or F,
    counted on F32_LAUNCHES."""
    m = 5
    with _recording_card(monkeypatch) as calls:
        fc1_w, fc2_w = torch.zeros((f, d)), torch.zeros((d, f))
        x, b1, b2 = torch.zeros((m, d)), torch.zeros(f), torch.zeros(d)
        before = (ffn.F32_LAUNCHES, ffn.TF32_LAUNCHES)
        y = ffn.ffn_fwd(x, fc1_w.t(), b1, fc2_w.t(), b2, False)
    assert [name for name, _ in calls] == [kernel, kernel]
    (_, fc1), (_, fc2) = calls
    assert fc1[:3] == (x.data_ptr(), fc1_w.data_ptr(), b1.data_ptr())
    assert fc1[4:9] == (m, f, d, ffn.ACT_GELU_ERF, 7)
    assert fc2[0] == fc1[3]  # the scratch h
    assert fc2[1:4] == (fc2_w.data_ptr(), b2.data_ptr(), y.data_ptr())
    assert fc2[4:9] == (m, d, f, ffn.ACT_NONE, 7)
    tf32 = kernel == "occm_ffn_gemm_3xtf32"
    assert (ffn.F32_LAUNCHES - before[0], ffn.TF32_LAUNCHES - before[1]) == (
        int(not tf32), int(tf32))


# ------------------------------------- a plain emulation of the split

def _tf32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """fp32 x with a 10-bit mantissa: "rn" rounds to nearest (ties away,
    as cvt.rna), "rz" clears the 13 low bits (the kernels' hi; also the
    worst the tensor cores can do with lo)."""
    bits = x.contiguous().view(torch.int32)
    if mode == "rn":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b, mode):
    """a @ b as the kernels issue it: x = hi + lo, both TF32, and the
    terms hi hi + (hi lo + lo hi), each product exact in fp32, sums in
    fp32."""
    a_hi, b_hi = _tf32(a, mode), _tf32(b, mode)
    a_lo, b_lo = _tf32(a - a_hi, mode), _tf32(b - b_hi, mode)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def _matmul_1xtf32(a, b, mode):
    return _tf32(a, mode) @ _tf32(b, mode)


def _attention_bwd(q, k, v, o, lse, do, mm):
    """flash_attention_bwd_reference in fp32 on [BH, T, D], every product
    through mm (all keys valid)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * scale
    p = torch.exp(mm(qs, k.transpose(-1, -2)) - lse[..., None])
    delta = torch.sum(do * o, dim=-1)[..., None]
    ds = p * (mm(do, v.transpose(-1, -2)) - delta)
    dv = mm(p.transpose(-1, -2), do)
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def _rel_of_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def attention_case():
    """fp32 q, k, v, dO at the training shape's T 299 and D 64 (two heads),
    with the plain version's out, lse and gradients."""
    rng = np.random.default_rng(19)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 299, 64))
                                    .astype(np.float32)) for _ in range(4))
    out, lse = attention.flash_attention_reference(q, k, v, 299)
    want = attention.flash_attention_bwd_reference(q, k, v, out, lse, do, 299)
    return (q, k, v, out, lse, do), want


@pytest.mark.parametrize("mode", ["rn", "rz"])
def test_3xtf32_attention_backward_meets_the_gate_where_1xtf32_does_not(
        attention_case, mode):
    """At D 64, T 299 the backward's seven products in 3xTF32 keep dq, dk
    and dv within 1e-5 of the largest |value| of the plain fp32 result
    (the card's gate, with either rounding of the split); one TF32 product
    each is off by more than that."""
    args, want = attention_case
    three = _attention_bwd(*args, lambda a, b: _matmul_3xtf32(a, b, mode))
    one = _attention_bwd(*args, lambda a, b: _matmul_1xtf32(a, b, mode))
    errs3 = [_rel_of_max(g, w) for g, w in zip(three, want)]
    errs1 = [_rel_of_max(g, w) for g, w in zip(one, want)]
    assert max(errs3) <= ATTENTION_RTOL_OF_MAX, errs3
    assert min(errs1) > ATTENTION_RTOL_OF_MAX, errs1


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("k", [1024, 4096])
def test_3xtf32_gemm_meets_the_ffn_gate_where_1xtf32_does_not(k, mode):
    """x [M, K] · W [K, N] at the FFN's depths (K = D = 1024 for fc1,
    K = F = 4096 for fc2), the weights at nn.Linear's scale: 3xTF32
    within 1e-4 of the largest |value| of the plain fp32 product, one TF32
    product beyond it."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(64, k)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.normal(size=(k, 256)))
                         .astype(np.float32))
    want = x @ w
    assert _rel_of_max(_matmul_3xtf32(x, w, mode), want) <= FFN_RTOL_OF_MAX
    assert _rel_of_max(_matmul_1xtf32(x, w, mode), want) > FFN_RTOL_OF_MAX


def test_the_split_is_exact_and_hi_is_tf32():
    """hi has no bit below TF32's mantissa, hi + lo gives x back exactly in
    fp32, and lo is below 2^-10 |x| (so lo's own rounding leaves at most
    2^-20 |x| out)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -20, 20, size=4096)).astype(np.float32))
    for mode in ("rn", "rz"):
        hi = _tf32(x, mode)
        lo = x - hi
        assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                           torch.zeros_like(hi, dtype=torch.int32))
        assert torch.equal(hi + lo, x)
        assert bool((lo.abs() <= 2.0 ** -10 * x.abs()).all())
