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


# ------------------------------------------------ the multi-tensor launch

def test_tables_cover_every_element_once(monkeypatch):
    """`build_tables`: each launch's chunks cover every element of every
    leaf with a gradient exactly once, leaves with a None gradient and
    empty leaves are absent, and no launch holds more than MAX_LEAVES
    leaves (the C table's size, `kMaxLeaves` in csrc/fused_adam.cu)."""
    import os
    import re

    src = os.path.join(os.path.dirname(fused_adam.__file__), os.pardir,
                       "csrc", "fused_adam.cu")
    with open(src) as f:
        c_max = int(re.search(r"kMaxLeaves = (\d+);", f.read()).group(1))
    assert fused_adam.MAX_LEAVES == c_max
    assert fused_adam.CHUNK % 4 == 0
    monkeypatch.setattr(fused_adam, "CHUNK", 8)
    monkeypatch.setattr(fused_adam, "MAX_LEAVES", 5)
    rng = np.random.default_rng(0)
    sizes = [int(n) for n in rng.integers(0, 40, size=23)] + [0, 8, 16, 17]
    present = [bool(x) for x in rng.random(len(sizes)) > 0.2]
    tables = fused_adam.build_tables(sizes, present)
    want = [i for i, (n, ok) in enumerate(zip(sizes, present)) if ok and n]
    assert [i for idx, _ in tables for i in idx] == want
    covered = {i: np.zeros(sizes[i], int) for i in want}
    for idx, starts in tables:
        assert 1 <= len(idx) <= 5 and starts[0] == 0
        assert len(starts) == len(idx) + 1
        for k, i in enumerate(idx):
            for c in range(starts[k + 1] - starts[k]):
                covered[i][c * 8:min((c + 1) * 8, sizes[i])] += 1
    assert all((c == 1).all() for c in covered.values())


def test_full_amodel_takes_one_launch():
    """The full AModel's 606 leaves, 596 with a gradient (the 10 of the
    AASIST `bn1` that never runs have none), fit one launch."""
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel

    with torch.device("meta"):
        named = list(AModel(AASISTConfig(), XLSRConfig()).named_parameters())
    present = [".bn1." not in n for n, _ in named]
    assert len(named) == 606 and sum(present) == 596
    tables = fused_adam.build_tables([p.numel() for _, p in named], present)
    assert len(tables) == 1 and len(tables[0][0]) == 596
    assert tables[0][1][-1] == sum(-(-p.numel() // fused_adam.CHUNK)
                                   for (_, p), ok in zip(named, present)
                                   if ok)


MIXED = ([(1,), (3,), (5,), (1027,), (64, 128), (2 * (1 << 16) + 3,)]
         + [(int(n),) for n in np.random.default_rng(5).integers(1, 300, 24)])
NONE_LEAF = 7  # a leaf whose gradient is None


@pytest.mark.parametrize("chunk", [1 << 16, 8], ids=["chunk64k", "chunk8"])
def test_step_over_mixed_leaves_matches_reference_and_jax(monkeypatch, chunk):
    """FusedAdam.step on the CPU over 30 leaves of mixed sizes (1, 3, 5,
    1027, an aligned [64, 128], one over two chunks, one None gradient)
    equals per-leaf `adam_reference` exactly, and JAX `FusedAdam` over 3
    steps at atol 1e-6 / rtol 1e-5 (tests/test_fused_adam.py's); the leaf
    without a gradient is left as it was."""
    monkeypatch.setattr(fused_adam, "CHUNK", chunk)
    lr = 1e-3
    rng = np.random.default_rng(6)
    init = [rng.normal(size=s).astype(np.float32) for s in MIXED]
    keys = [f"l{i:02d}" for i in range(len(MIXED)) if i != NONE_LEAF]
    jopt = JFusedAdam(lr, interpret=True)
    jp = {k: jnp.asarray(init[int(k[1:])]) for k in keys}
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in init]
    rp = [torch.from_numpy(a.copy()) for a in init]
    rm = [torch.zeros_like(t) for t in rp]
    rv = [torch.zeros_like(t) for t in rp]
    topt = fused_adam.FusedAdam(lr).init(tp)
    for step in range(3):
        g = [rng.normal(size=s).astype(np.float32) for s in MIXED]
        tg = [None if i == NONE_LEAF else torch.from_numpy(a)
              for i, a in enumerate(g)]
        topt.step(tp, tg)
        inv1, inv2 = fused_adam.bias_corrections(step + 1, 0.9, 0.999)
        for i in range(len(MIXED)):
            if i != NONE_LEAF:
                fused_adam.adam_reference(rp[i], rm[i], rv[i], tg[i], inv1,
                                          inv2, lr, 0.9, 0.999, 1e-8)
        jp, jstate = jopt.apply(
            jp, {k: jnp.asarray(g[int(k[1:])]) for k in keys}, jstate)
    for i, (a, b) in enumerate(zip(tp, rp)):
        assert torch.equal(a, b), i
        assert torch.equal(topt.mu[i], rm[i]) and torch.equal(topt.nu[i],
                                                               rv[i])
    assert torch.equal(tp[NONE_LEAF], torch.from_numpy(init[NONE_LEAF]))
    for k in keys:
        i = int(k[1:])
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(topt.nu[i].numpy(),
                                   np.asarray(jstate.nu[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_plan_is_kept_across_steps_and_rebuilt_when_gradients_change():
    """The p, m, v part of the launch table is built once per parameter
    list and set of gradients present, not per step."""
    tp = [torch.ones(4), torch.ones(3)]
    opt = fused_adam.FusedAdam(0.1).init(tp)
    opt.step(tp, [torch.ones(4), torch.ones(3)])
    plan = opt._plan
    opt.step(tp, [torch.ones(4), torch.ones(3)])
    assert opt._plan is plan
    opt.step(tp, [torch.ones(4), None])
    assert opt._plan is not plan and opt._plan.tables == [([0], [0, 1])]
    opt.step(list(tp), [torch.ones(4), None])  # same tensors, new list
    assert opt._plan.matches(tp, opt.mu, opt.nu, (True, False))


def test_plan_is_rebuilt_when_storage_is_replaced():
    """The launch table holds raw p, m, v pointers. A parameter whose
    storage is replaced while the Parameter object stays (`.data = ...`, as
    `model.to()` and `load_state_dict(assign=True)` do) and moments that
    are reassigned get a new plan that points at the new storage, and the
    update still equals `adam_reference` on it."""
    tp = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.ones(3))]
    rp = [torch.ones(4), torch.ones(3)]
    rm = [torch.zeros(4), torch.zeros(3)]
    rv = [torch.zeros(4), torch.zeros(3)]
    opt = fused_adam.FusedAdam(0.1).init(tp)
    g = [torch.full((4,), 0.5), torch.full((3,), -2.0)]

    def step():
        opt.step(tp, g)
        inv1, inv2 = fused_adam.bias_corrections(opt.count, 0.9, 0.999)
        for i in range(2):
            fused_adam.adam_reference(rp[i], rm[i], rv[i], g[i], inv1, inv2,
                                      0.1, 0.9, 0.999, 1e-8)

    step()
    plan = opt._plan
    tp[0].data = torch.full((4,), 2.0)
    rp[0] = torch.full((4,), 2.0)
    step()
    assert opt._plan is not plan
    assert opt._plan.arrays[0][0][0] == tp[0].data_ptr()
    plan = opt._plan
    opt.mu = [m.clone() for m in opt.mu]
    step()
    assert opt._plan is not plan
    assert opt._plan.arrays[0][1][1] == opt.mu[1].data_ptr()
    for i in range(2):
        assert torch.equal(tp[i].detach(), rp[i]), i
        assert torch.equal(opt.mu[i], rm[i]) and torch.equal(opt.nu[i], rv[i])
