"""The port's fused FFN (`occm_tpu_torch.ops.ffn`) against the JAX Pallas
kernel (`occm_tpu.ops.ffn.fused_ffn`, interpret mode) on the CPU.

D = 128 and F = 1024 so that the JAX side really runs its kernel (two F
tiles of 512, so the fp32 accumulation over tiles is covered; smaller dims
take its XLA route). x is [2, 150, 128]: M = 300, padded by JAX to 512. On
the CPU the port runs the kernel's plain version, `ffn_reference`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.ops.ffn import fused_ffn as jax_fused_ffn
from occm_tpu_torch.ops import ffn
from occm_tpu_torch.ops.ffn import ffn_fwd, ffn_reference, fused_ffn

D, F_ = 128, 1024


def _inputs(m=300, seed=0, d=D, f=F_):
    """x ~ N(0, 1), weights with std 0.02 (the model's init scale), biases
    std 0.01, as numpy float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, m // 2, d)).astype(np.float32),
            (rng.normal(size=(d, f)) * 0.02).astype(np.float32),
            (rng.normal(size=(f,)) * 0.01).astype(np.float32),
            (rng.normal(size=(f, d)) * 0.02).astype(np.float32),
            (rng.normal(size=(d,)) * 0.01).astype(np.float32))


def _assert_bf16_close(got, want):
    """The bound of test_forward_matches_pallas_bf16 (its docstring gives
    the reason)."""
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert np.all(err <= 2.0 ** -7 * (np.abs(want) + scale / 16)), err.max()
    assert np.mean(err == 0) > 0.9


def _jax(args, approximate, dtype):
    return np.asarray(jax_fused_ffn(
        *(jnp.asarray(a, dtype) for a in args), approximate=approximate,
        interpret=True).astype(jnp.float32))


def _torch(args, approximate, dtype):
    return fused_ffn(*(torch.from_numpy(a).to(dtype) for a in args),
                     approximate=approximate)


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_forward_matches_pallas_fp32(approximate):
    args = _inputs()
    want = _jax(args, approximate, jnp.float32)
    got = _torch(args, approximate, torch.float32)
    assert got.shape == (2, 150, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_forward_matches_pallas_bf16(approximate):
    """Both sides take the same bf16 inputs, form exact products, sum them
    in fp32 and round the hidden activation and the output once each to
    bf16: they differ by summation order, which can flip one rounding of an
    output by one bf16 ulp (at most 2^-7 |y|), or one rounding of a hidden
    element, whose effect on y is far below that. Bound: one ulp of the
    output's magnitude, 2^-7 * |y|, plus 2^-7 * max|y| / 16 for values
    near zero."""
    args = _inputs(seed=1)
    want = _jax(args, approximate, jnp.bfloat16)
    got = _torch(args, approximate, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # not a trivially loose bound: most elements agree exactly
    _assert_bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_forward_past_the_old_width_limit_matches_pallas(approximate, dtype):
    """D = 1280, which the earlier kernel refused (it took D <= 1024), with
    F = 1024 and M = 64 (the JAX kernel needs D % 128 = 0 and F % 512 = 0
    and pads M to 512): `ffn_reference` and `fused_ffn` against the JAX
    kernel at this file's tolerances, fp32 as
    test_forward_matches_pallas_fp32 and bf16 as
    test_forward_matches_pallas_bf16."""
    d = 1280
    args = _inputs(m=64, seed=3, d=d, f=1024)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _jax(args, approximate, jdt)
    got = _torch(args, approximate, tdt)
    ts = [torch.from_numpy(a).to(tdt) for a in args]
    ref = ffn_reference(ts[0].reshape(-1, d), *ts[1:], approximate)
    assert got.shape == (2, 32, d) and got.dtype == tdt
    assert torch.equal(ref, got.reshape(-1, d))
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:
        _assert_bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_gradients_match_pallas_custom_vjp(approximate):
    """Gradients of sum(y^2) through JAX's custom VJP (`_ffn_bwd`) and the
    port's backward, at M = 128 in fp32 (tolerance of
    tests/test_ops.py::TestFusedFFN::test_gradients_match_xla)."""
    args = _inputs(m=128, seed=2)

    def loss(a):
        return jnp.sum(jax_fused_ffn(*a, approximate=approximate,
                                     interpret=True) ** 2)

    want = jax.grad(loss)(tuple(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (fused_ffn(*ts, approximate=approximate) ** 2).sum().backward()
    for name, t, w in zip(("x", "w1", "b1", "w2", "b2"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(w).reshape(t.shape),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def test_reference_is_the_plain_version_and_counts_nothing_on_cpu():
    """On a CPU tensor the wrapper is exactly `ffn_reference` and launches
    no kernel."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(m=64))
    ffn.LAUNCHES = 0
    x2d = x.reshape(-1, D).to(torch.bfloat16)
    w = [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]
    assert torch.equal(ffn_fwd(x2d, *w, False),
                       ffn_reference(x2d, *w, False))
    with torch.inference_mode():
        fused_ffn(x, w1, b1, w2, b2, approximate=True)
    assert ffn.LAUNCHES == 0


def test_bad_shapes_and_devices_raise():
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(m=64))
    x2d = x.reshape(-1, D)
    with pytest.raises(ValueError, match=r"x \[M, D\]"):
        ffn_fwd(x, w1, b1, w2, b2, True)
    with pytest.raises(ValueError, match="expected w1"):
        ffn_fwd(x2d, w1[:, :512], b1, w2, b2, True)
    with pytest.raises(ValueError, match="expected w1"):
        ffn_fwd(x2d, w1, b1, w2, b2[:64], True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ffn_fwd(x2d.to("meta"), *(t.to("meta") for t in (w1, b1, w2, b2)),
                True)


def test_cuda_path_rejects_what_the_kernel_does_not_take(monkeypatch):
    """On a CUDA tensor the wrapper routes bf16 to the wgmma kernel and
    fp32 to the fp32 kernel (csrc/ffn_fwd_f32.cu, any shape), and raises
    before it builds or launches anything for fp16, for mixed dtypes and,
    in bf16, for row strides TMA cannot take (D or F not a multiple of 8:
    16-byte strides); it never routes to the plain version. Widths past
    the earlier kernel's D <= 1024 limit go on to the build, and so do
    fp32 widths that are not multiples of 8. Checked with the device test
    patched, as this host has no card."""
    from occm_tpu_torch.ops import _build

    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(m=64))
    x2d = x.reshape(-1, D)
    bf = [t.to(torch.bfloat16) for t in (x2d, w1, b1, w2, b2)]
    odd_d = [bf[0][:, :100], bf[1][:100], bf[2], bf[3][:, :100], bf[4][:100]]
    odd_f = [bf[0], bf[1][:, :1020], bf[2][:1020], bf[3][:1020], bf[4]]
    wide = [torch.zeros(s, dtype=torch.bfloat16)
            for s in ((4, 1280), (1280, 64), (64,), (64, 1280), (1280,))]
    f32_odd = [t.float() for t in odd_d]
    half = [t.to(torch.float16) for t in (x2d, w1, b1, w2, b2)]
    mixed = [x2d, *bf[1:]]

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    class Built(Exception):
        pass

    def load():
        raise Built

    monkeypatch.setattr(ffn, "ffn_reference", plain)
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    for args in (half, mixed):
        with pytest.raises(ValueError, match="bf16 or fp32"):
            ffn_fwd(*args, True)
    for args in (odd_d, odd_f):
        with pytest.raises(ValueError, match="multiples of 8"):
            ffn_fwd(*args, True)
    for args in (wide, [x2d, w1, b1, w2, b2], f32_odd):
        with pytest.raises(Built):
            ffn_fwd(*args, True)


@pytest.mark.parametrize("m, d, f", [(37, 96, 200), (1, 40, 72),
                                     (130, 130, 129)])
@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_fp32_plain_version_at_ragged_shapes_matches_jax(m, d, f,
                                                         approximate):
    """The fp32 kernel takes any M, D, F, masking the ragged 128 x 128
    tiles and 8-deep K steps; its plain version at such shapes against
    the JAX package's fused_ffn (which takes its XLA route there, the
    same function) at test_forward_matches_pallas_fp32's tolerance, and
    no launch counted on the CPU."""
    rng = np.random.default_rng(m + d + f)
    args = [(rng.normal(size=s) * sd).astype(np.float32)
            for s, sd in (((m, d), 1.0), ((d, f), 0.05), ((f,), 0.01),
                          ((f, d), 0.05), ((d,), 0.01))]
    want = np.asarray(jax_fused_ffn(*map(jnp.asarray, args),
                                    approximate=approximate))
    before = (ffn.LAUNCHES, ffn.F32_LAUNCHES)
    got = ffn_fwd(*map(torch.from_numpy, args), approximate)
    assert (ffn.LAUNCHES, ffn.F32_LAUNCHES) == before
    assert got.shape == (m, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
