"""The port's optimizers against the JAX package's: `FusedAdam` (on the CPU
its plain version, `adam_reference`) against JAX `FusedAdam` in interpret
mode over 5 steps, on a lane-aligned leaf (the Pallas kernel's route) and a
ragged one (the JAX fallback's), atol 1e-6 / rtol 1e-5 as
tests/test_fused_adam.py; and the trainer's "adam" (torch.optim.Adam with
optax's constants) against optax.adam.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from occm_tpu.ops.fused_adam import FusedAdam as JFusedAdam
from occm_tpu_torch.config import TrainConfig
from occm_tpu_torch.ops import fused_adam
from occm_tpu_torch.train.state import make_optimizer

SHAPES = {"aligned": (64, 128), "ragged": (7, 13), "bias": (5,)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def test_fused_adam_matches_jax_over_steps():
    lr = 1e-3
    params = _params()
    jopt = JFusedAdam(lr, interpret=True)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    topt = fused_adam.FusedAdam(lr).init(tp)
    for step in range(5):
        g = _grads(step)
        jp, jstate = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                jstate)
        topt.step(tp, [torch.from_numpy(g[k]) for k in SHAPES])
    assert topt.count == int(jstate.count) == 5
    for k, t, m, v in zip(SHAPES, tp, topt.mu, topt.nu):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(m.numpy(), np.asarray(jstate.mu[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.nu[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


def test_torch_adam_matches_optax_adam():
    """"adam" is torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8),
    optax.adam's constants, never fused=True."""
    lr = 1e-3
    params = _params(1)
    tx = optax.adam(lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in SHAPES]
    opt = make_optimizer(TrainConfig(lr=lr), tp)
    assert isinstance(opt, torch.optim.Adam)
    assert not opt.defaults.get("fused")
    for step in range(5):
        g = _grads(step)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tp, SHAPES):
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in zip(SHAPES, tp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


def test_make_optimizer_fused_adam_and_skipped_leaves():
    """"fused_adam" is the kernel's FusedAdam; a leaf without a gradient
    (a parameter the forward never used) is left as it is."""
    tp = [torch.ones(4), torch.ones(3)]
    opt = make_optimizer(TrainConfig(optimizer="fused_adam", lr=0.1), tp)
    assert isinstance(opt, fused_adam.FusedAdam) and opt.lr == 0.1
    opt.step(tp, [torch.ones(4), None])
    torch.testing.assert_close(tp[0], torch.full((4,), 0.9))
    torch.testing.assert_close(tp[1], torch.ones(3))
    assert torch.count_nonzero(opt.mu[1]) == 0


def test_bias_corrections_in_fp32():
    inv1, inv2 = fused_adam.bias_corrections(3, 0.9, 0.999)
    assert inv1 == pytest.approx(1.0 / (1.0 - 0.9 ** 3), rel=1e-6)
    assert inv2 == pytest.approx(1.0 / (1.0 - 0.999 ** 3), rel=1e-5)


@pytest.mark.parametrize("bad", ["shape", "device"])
def test_leaf_wrapper_rejects_bad_arguments(bad):
    p, m, v, g = (torch.zeros(4) for _ in range(4))
    if bad == "shape":
        g = torch.zeros(5)
    else:
        p, m, v, g = (x.to("meta") for x in (p, m, v, g))
    with pytest.raises(ValueError):
        fused_adam.fused_adam_leaf(p, m, v, g, 1.0, 1.0, 1e-3, 0.9, 0.999,
                                   1e-8)
