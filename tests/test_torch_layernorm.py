"""The port's LayerNorm (`occm_tpu_torch.ops.layernorm.fast_layer_norm`)
against the JAX package's `occm_tpu.ops.layernorm.fast_layer_norm`.

d = 1024, 1280 and 128 take the JAX side's Pallas backward (`_bwd_kernel`,
in interpret mode; d = 1000 its XLA fallback); M is not a multiple of its
512-row tile, so the JAX wrapper pads and the port does not need to. On the CPU the port's backward
runs `layer_norm_bwd_reference`, the CUDA kernel's plain version (the
kernel itself is held against it on the card by chip_smoke.py).
Tolerances: forward 1e-5, gradients rtol/atol 2e-4, those of
tests/test_ops.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.ops.layernorm import fast_layer_norm as jax_fast_layer_norm
from occm_tpu_torch.ops import layernorm


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = rng.normal(size=shape).astype(np.float32) * 2.0 + 0.5
    gamma = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    beta = (0.1 * rng.normal(size=d)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, g


@pytest.mark.parametrize("shape", [
    (3, 201, 128), (700, 1024),
    (3, 201, 1024),  # ragged M = 603, the model's width
    (5, 1280),       # past 1024: the kernel's wider instance
    (6, 1000),       # D not a multiple of the kernel's 256-wide lanes
])
def test_forward_and_gradients_match_jax(shape):
    x, gamma, beta, g = _inputs(shape, seed=shape[-1])
    eps = 1e-5
    y_j, vjp = jax.vjp(
        lambda a, b, c: jax_fast_layer_norm(a, b, c, eps, True),
        *map(jnp.asarray, (x, gamma, beta)))
    want = vjp(jnp.asarray(g))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    y = layernorm.fast_layer_norm(tx, tg, tb, eps)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(y, (tx, tg, tb), torch.from_numpy(g))
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_bf16_input_keeps_its_dtype():
    """The bf16 norm path: fp32 statistics, output (and dx) in the input
    dtype, gamma and beta gradients in theirs."""
    x, gamma, beta, g = _inputs((5, 128), seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tg, tb = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
    y = layernorm.fast_layer_norm(xb, tg, tb)
    assert y.dtype == torch.bfloat16
    want = torch.nn.functional.layer_norm(
        xb.float(), (128,), tg, tb, 1e-5).to(torch.bfloat16)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    dx, dgamma, dbeta = torch.autograd.grad(
        y, (xb, tg, tb), torch.from_numpy(g).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16
    assert dgamma.dtype == dbeta.dtype == torch.float32


def test_plain_backward_matches_autograd():
    x, gamma, beta, g = _inputs((37, 96), seed=2)
    tx, tg, tb = (torch.from_numpy(a).double().requires_grad_()
                  for a in (x, gamma, beta))
    y = torch.nn.functional.layer_norm(tx, (96,), tg, tb, 1e-5)
    want = torch.autograd.grad(y, (tx, tg, tb),
                               torch.from_numpy(g).double())
    got = layernorm.layer_norm_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(g),
        1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_cpu_backward_counts_no_launch():
    x, gamma, beta, _ = _inputs((4, 128), seed=3)
    before = layernorm.LAUNCHES
    tx = torch.from_numpy(x).requires_grad_()
    layernorm.fast_layer_norm(tx, torch.from_numpy(gamma),
                              torch.from_numpy(beta)).sum().backward()
    assert tx.grad is not None and layernorm.LAUNCHES == before


@pytest.mark.parametrize("bad", ["gamma", "rank", "device"])
def test_wrapper_rejects_bad_arguments(bad):
    x, g, gamma = torch.zeros(4, 8), torch.zeros(4, 8), torch.ones(8)
    if bad == "gamma":
        gamma = torch.ones(7)
    elif bad == "rank":
        x, g = torch.zeros(2, 4, 8), torch.zeros(2, 4, 8)
    else:
        x, g, gamma = (a.to("meta") for a in (x, g, gamma))
    with pytest.raises(ValueError):
        layernorm.layer_norm_bwd(x, gamma, g, 1e-5)


def test_cuda_path_rejects_what_the_kernel_does_not_take(monkeypatch):
    """On a CUDA tensor the wrapper raises for a dtype or width the kernel
    does not take, before it builds or launches anything, and never routes
    to the plain version; D = 1000 and 2048 go on to the build. Checked with
    the device patched, as this host has no card."""
    from occm_tpu_torch.ops import _build

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    class Built(Exception):
        pass

    def load():
        raise Built

    monkeypatch.setattr(layernorm, "layer_norm_bwd_reference", plain)
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    gamma = torch.ones(2049)
    with pytest.raises(ValueError, match="D <= 2048"):
        layernorm.layer_norm_bwd(torch.zeros(4, 2049), gamma,
                                 torch.zeros(4, 2049), 1e-5)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        layernorm.layer_norm_bwd(torch.zeros(4, 8, dtype=torch.float16),
                                 gamma[:8], torch.zeros(4, 8), 1e-5)
    for d in (1000, 2048):
        with pytest.raises(Built):
            layernorm.layer_norm_bwd(
                torch.zeros(3, d, dtype=torch.bfloat16), gamma[:d],
                torch.zeros(3, d, dtype=torch.bfloat16), 1e-5)
