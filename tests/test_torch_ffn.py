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


def _inputs(m=300, seed=0):
    """x ~ N(0, 1), weights with std 0.02 (the model's init scale), biases
    std 0.01, as numpy float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, m // 2, D)).astype(np.float32),
            (rng.normal(size=(D, F_)) * 0.02).astype(np.float32),
            (rng.normal(size=(F_,)) * 0.01).astype(np.float32),
            (rng.normal(size=(F_, D)) * 0.02).astype(np.float32),
            (rng.normal(size=(D,)) * 0.01).astype(np.float32))


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
    got = got.float().numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert np.all(err <= 2.0 ** -7 * (np.abs(want) + scale / 16)), err.max()
    # not a trivially loose bound: most elements agree exactly
    assert np.mean(err == 0) > 0.9


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
    """On a CUDA tensor the wrapper raises for fp32 and for widths the
    kernel does not take, before it builds or launches anything; it never
    routes to the plain version. Checked with the device test patched, as
    this host has no card."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(m=64))
    x2d = x.reshape(-1, D)
    bf = [t.to(torch.bfloat16) for t in (x2d, w1, b1, w2, b2)]
    narrow = [bf[0][:, :96], bf[1][:96], bf[2], bf[3][:, :96], bf[4][:96]]
    wide = [torch.zeros(s, dtype=torch.bfloat16)
            for s in ((4, 1088), (1088, 64), (64,), (64, 1088), (1088,))]

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ffn, "ffn_reference", plain)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="bf16"):
        ffn_fwd(x2d, w1, b1, w2, b2, True)
    with pytest.raises(ValueError, match="multiples of 64"):
        ffn_fwd(*narrow, True)
    with pytest.raises(ValueError, match="D <= 1024"):
        ffn_fwd(*wide, True)
