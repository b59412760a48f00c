"""The 3xTF32 attention forward's arithmetic (csrc/flash_attn_fwd_3xtf32.cu)
emulated in plain fp32 and held against the JAX package's fp32 Pallas
forward kernels in interpret mode.

The kernel runs only on the card (chip_smoke.py phase 20 holds it against
its plain version there). The emulation repeats what it does: qs = q *
scale in fp32; every product split x = hi + lo (hi = x with its 13 low
mantissa bits cleared, lo = x - hi), the tensor cores reading lo's TF32
value rounded ("rn") or truncated ("rz"), a_hi b_hi plus a small
accumulator of a_hi b_lo + a_lo b_hi; an online softmax over tiles of 64
keys in base 2; each tile's P v in fresh accumulators added to the running
O. T 299 takes the JAX package's whole-T kernel (`_fwd_kernel`), T 600 its
blocked one (`_blocked_fwd_kernel`, which also gives the lse held here at
both T). In either mode it meets phase 20's gate, COVERAGE_F32_RTOL_OF_MAX
= 1e-5 of the largest |out| and of the largest |lse|, where one TF32
product a step does not.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occm_tpu.ops import attention as jax_attention

#: chip_smoke.py's COVERAGE_F32_RTOL_OF_MAX, for out and lse alike
RTOL_OF_MAX = 1e-5
KEYS = 64  # keys of a kv tile
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The file's torch ops run on one thread: the suite's workers share
    the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _truncate(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared (the kernel's hi)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """What a tensor-core product reads of fp32 x: "rn" rounds to TF32's
    10-bit mantissa (ties away), "rz" truncates."""
    if mode == "rz":
        return _truncate(x)
    bits = x.contiguous().view(torch.int32) + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b, mode):
    """a @ b as the kernel issues it: hi exact, lo read as TF32, hi hi in
    one sum and hi lo + lo hi in a small one added at the end."""
    a_hi, b_hi = _truncate(a), _truncate(b)
    a_lo, b_lo = _tf32(a - a_hi, mode), _tf32(b - b_hi, mode)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def _mm_1xtf32(a, b, mode):
    return _tf32(a, mode) @ _tf32(b, mode)


def emulated_forward(q, k, v, t_valid, mm):
    """The kernel's forward on [BH, T, D] fp32 through the product `mm`:
    (out [BH, T, D], lse [BH, T])."""
    bh, t, d = q.shape
    qs = q * (1.0 / math.sqrt(d))
    o = torch.zeros_like(q)
    m = torch.full((bh, t, 1), -1e30)
    l = torch.zeros((bh, t, 1))
    for kv0 in range(0, t_valid, KEYS):
        kt = k[:, kv0:kv0 + KEYS].transpose(-1, -2)
        s = mm(qs, kt)
        key = torch.arange(kv0, kv0 + s.shape[-1])
        s = s.masked_fill(key >= t_valid, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * LOG2E - m_new * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[:, kv0:kv0 + KEYS])
        m = m_new
    return o / l, (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]


def _rel_of_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module", params=[(299, 64), (600, 64), (299, 16),
                                        (600, 16)],
                ids=["T299-D64", "T600-D64", "T299-D16", "T600-D16"])
def pallas_case(request):
    """fp32 q, k, v [B 1, T, H 2, D] from seed T + D, the JAX package's
    Pallas forward of them in interpret mode (the whole-T kernel at T 299,
    the blocked one at T 600), and its blocked kernel's lse."""
    t, d = request.param
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.normal(size=(1, t, 2, d)).astype(np.float32)
               for _ in range(3))
    out = np.asarray(jax_attention.flash_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True))
    blk = jax_attention._pick_blk(t)
    tp = -(-t // blk) * blk
    pad = ((0, 0), (0, 0), (0, tp - t), (0, 0))
    _, lse = jax_attention._run_blocked_fwd(
        *(jnp.pad(jnp.asarray(x).transpose(0, 2, 1, 3), pad)
          for x in (q, k, v)), t, 1.0 / math.sqrt(d), True)

    def flat(x):
        return torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 2, 1, 3).reshape(2, t, d)))

    return ((flat(q), flat(k), flat(v)), flat(out),
            torch.from_numpy(np.array(lse)[:, :t, 0]))


@pytest.mark.parametrize("mode", ["rn", "rz"])
def test_3xtf32_forward_meets_the_gate_where_1xtf32_does_not(pallas_case,
                                                             mode):
    """The emulated kernel's out and lse within 1e-5 of the largest |value|
    of the Pallas kernels' fp32 results, with either rounding of the
    tensor cores; one TF32 product a step misses the bound on out."""
    (q, k, v), want_out, want_lse = pallas_case
    t = q.shape[1]
    out, lse = emulated_forward(q, k, v, t,
                                lambda a, b: _mm_3xtf32(a, b, mode))
    errs = {"out": _rel_of_max(out, want_out),
            "lse": _rel_of_max(lse, want_lse)}
    assert max(errs.values()) <= RTOL_OF_MAX, errs
    one, _ = emulated_forward(q, k, v, t,
                              lambda a, b: _mm_1xtf32(a, b, mode))
    assert _rel_of_max(one, want_out) > RTOL_OF_MAX


def test_emulation_masks_keys_past_t_valid():
    """With t_valid short of T the keys past it get no probability: what
    lies there (here 1e3 in k and -7 in v) leaves the emulated out and lse
    unchanged bit for bit (the last tile is partly masked), and both stay
    within the gate of the port's plain version."""
    from occm_tpu_torch.ops import attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 150, 16))
                                .astype(np.float32)) for _ in range(3))

    def mm(a, b):
        return _mm_3xtf32(a, b, "rz")

    out, lse = emulated_forward(q, k, v, 100, mm)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:], v2[:, 100:] = 1e3, -7.0
    out2, lse2 = emulated_forward(q, k2, v2, 100, mm)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref_out, ref_lse = attention.flash_attention_reference(q, k, v, 100)
    assert _rel_of_max(out, ref_out) <= RTOL_OF_MAX
    assert _rel_of_max(lse, ref_lse) <= RTOL_OF_MAX
