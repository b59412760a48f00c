"""The remat policies of the port's XLSR encoder (`occm_tpu_torch.models.
remat`) on the CPU, at `XLSRConfig.tiny()` with remat on (tiny has it off,
so JAX's own ladder test never runs a policy).

- Every policy, on every attention, FFN and LayerNorm implementation the
  port has (through their plain versions here), gives the forward and the
  gradients of the model without remat bit for bit: a policy only decides
  what is kept and what is recomputed.
- Each policy against the Flax encoder with the same policy: forward atol
  2e-5, gradients atol 5e-4 / rtol 1e-3 (the JAX suite's gradient
  tolerance, tests/test_attention.py).
- What each policy keeps and what its backward recomputes, counted with a
  dispatch mode around backward() and held against the dot_general
  equations of JAX's backward (the recompute of its remat'd scan body).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.extend
import jax.numpy as jnp

from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models import XLSREncoder, remat, xlsr_state_dict_from_flax
from test_torch_models import fabricated, perturbed

CUT = 3200  # tiny conv stack: 159 frames
POLICIES = ("nothing", "dots", "attn_out", "attn_out_inner", "attn_probs",
            "attn_all")


def _cfg(policy="nothing", attention="xla", kernels="xla", **kw):
    return dataclasses.replace(
        XLSRConfig.tiny(), remat=True, remat_policy=policy,
        attention_impl=attention, ffn_impl=kernels, ln_impl=kernels, **kw)


def _wave(seed=3, batch=2):
    return (np.random.default_rng(seed).normal(size=(batch, CUT))
            * 0.1).astype(np.float32)


def _run(cfg, x, state=None):
    """(features, {name: gradient} incl. the wave's) of one backward of the
    sum of squared features, from seed-0 weights (or `state`)."""
    torch.manual_seed(0)
    model = XLSREncoder(cfg).train()
    if state is not None:
        model.load_state_dict(state, strict=True)
    wave = torch.from_numpy(x).requires_grad_()
    y = model(wave)
    (y ** 2).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads["wave"] = wave.grad
    return y.detach(), grads


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gives_the_numbers_of_no_remat(policy, attention, kernels):
    x = _wave()
    want_y, want_g = _run(dataclasses.replace(
        _cfg("nothing", attention, kernels), remat=False), x)
    got_y, got_g = _run(_cfg(policy, attention, kernels), x)
    assert torch.equal(got_y, want_y)
    assert got_g.keys() == want_g.keys()
    for n, g in want_g.items():
        assert torch.equal(got_g[n], g), n


def _jax_variables(jcfg, x, seed):
    return perturbed(fabricated(JXLSREncoder(jcfg), x), seed)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_flax(policy):
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), remat=True,
                               remat_policy=policy)
    cfg = _cfg(policy)
    x = _wave(seed=5)
    variables = _jax_variables(jcfg, x, seed=POLICIES.index(policy))
    jmodel = JXLSREncoder(jcfg)

    def loss(params):
        y = jmodel.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(y ** 2), y

    (_, want_y), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    got_y, got_g = _run(cfg, x, xlsr_state_dict_from_flax(
        variables["params"], cfg))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=2e-5,
                               rtol=0)
    want = xlsr_state_dict_from_flax(jgrads, cfg)
    # both train the positional conv's folded kernel: the bridge's
    # weight_v of a gradient tree is that kernel's gradient
    want["encoder.pos_conv.0.weight"] = want.pop("encoder.pos_conv.0.weight_v")
    want.pop("encoder.pos_conv.0.weight_g")
    assert want.keys() == set(got_g) - {"wave"}
    for n, w in want.items():
        np.testing.assert_allclose(got_g[n].numpy(), w.numpy(), atol=5e-4,
                                   rtol=1e-3, err_msg=n)


# ------------------------------------------------ what is kept, recomputed

class _Ops(TorchDispatchMode):
    """Counts the matmuls and softmaxes run, by what they make (a call on
    meta tensors computes nothing: remat sizes a skipped op that way)."""

    def __init__(self, cfg, batch):
        super().__init__()
        d, f, h = (cfg.encoder_embed_dim, cfg.encoder_ffn_dim,
                   cfg.encoder_heads)
        self.kinds = {(batch * 159, d): "proj", (batch * 159, f): "fc1",
                      (batch * h, 159, 159): "qk",
                      (batch * h, 159, d // h): "pv"}
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not isinstance(out, torch.Tensor) or out.device.type == "meta":
            pass
        elif func in (torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.mm.default):
            self.count[self.kinds.get(tuple(out.shape), "other")] += 1
        elif func is torch.ops.aten._softmax.default:
            self.count["softmax"] += 1
        return out


def _backward_ops(cfg, x):
    torch.manual_seed(0)
    model = XLSREncoder(cfg).train()
    y = model(torch.from_numpy(x).requires_grad_())
    with _Ops(cfg, x.shape[0]) as ops:
        (y ** 2).sum().backward()
    return ops.count


def _jax_recomputed_dots(policy, attention, x):
    """dot_general equations a layer's backward recomputes in JAX: those of
    the backward scan body less the transposes (the same body under
    "dots", which recomputes none)."""
    def dots(pol):
        jcfg = dataclasses.replace(JXLSRConfig.tiny(), remat=True,
                                   remat_policy=pol, attention_impl=attention)
        enc = JXLSREncoder(jcfg)
        shapes = jax.eval_shape(lambda x: enc.init(jax.random.PRNGKey(0), x),
                                x)
        params = jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        jaxpr = jax.make_jaxpr(jax.grad(
            lambda p: jnp.sum(enc.apply(p, x) ** 2)))(params).jaxpr
        bodies = []
        _walk(jaxpr, lambda e: bodies.append(e.params["jaxpr"].jaxpr)
              if e.primitive.name == "scan" else None)
        assert len(bodies) == 2  # the forward scan, then the backward's
        n = [0]
        _walk(bodies[1], lambda e: n.__setitem__(
            0, n[0] + (e.primitive.name == "dot_general")))
        return n[0]

    return dots(policy) - dots("dots")


def _walk(jaxpr, visit):
    core = jax.extend.core
    for e in jaxpr.eqns:
        visit(e)
        if e.primitive.name == "pallas_call":
            continue  # a kernel's body is not the layer's
        for p in e.params.values():
            for s in p if isinstance(p, (list, tuple)) else [p]:
                if isinstance(s, core.ClosedJaxpr):
                    _walk(s.jaxpr, visit)
                elif isinstance(s, core.Jaxpr):
                    _walk(s, visit)


#: per layer, what the backward recomputes on each path: projections
#: (q/k/v/out), fc1, QK^T, P.V and softmaxes. The projections each policy
#: keeps are not recomputed, nor is fc2 (its output is not needed), nor
#: any matmul under "dots"; attn_out_inner keeps P.V's output, attn_probs
#: the softmax (and so needs no QK^T), attn_all also q, k and v.
RECOMPUTED = {
    "xla": {"nothing": (4, 1, 1, 1, 1), "dots": (0, 0, 0, 0, 1),
            "attn_out": (3, 1, 1, 1, 1), "attn_out_inner": (3, 1, 1, 0, 1),
            "attn_probs": (3, 1, 0, 0, 0), "attn_all": (0, 1, 0, 0, 0)},
    # the flash kernel's own products (its plain version here) are not
    # counted: the port's CUDA backward reads the forward's output and
    # log-sum-exp, so every policy reruns the flash forward
    "flash": {"nothing": (4, 1), "dots": (0, 0), "attn_out": (3, 1),
              "attn_out_inner": (3, 1), "attn_probs": (3, 1),
              "attn_all": (0, 1)},
}
#: the recompute JAX runs beyond its policy: jax.nn.softmax's custom JVP
#: keeps its own unnamed output, so under attn_probs and attn_all JAX still
#: recomputes QK^T (and the softmax) for the softmax's backward
JAX_EXTRA = {"attn_probs": 1, "attn_all": 1}


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_backward_recomputes_what_the_policy_does_not_keep(policy,
                                                           attention):
    x = _wave(batch=1)
    cfg = _cfg(policy, attention)
    layers = cfg.encoder_layers
    base = _backward_ops(dataclasses.replace(cfg, remat=False), x)
    got = _backward_ops(cfg, x)
    extra = {k: got[k] - base[k] for k in ("proj", "fc1", "qk", "pv",
                                           "softmax")}
    assert got["other"] == base["other"]
    want = RECOMPUTED[attention][policy]
    assert extra["proj"] == layers * want[0]
    assert extra["fc1"] == layers * want[1]
    if attention == "xla":
        assert (extra["qk"], extra["pv"], extra["softmax"]) == tuple(
            layers * n for n in want[2:])
    matmuls = sum(want[:4]) if attention == "xla" else sum(want)
    jx = _jax_recomputed_dots(policy, attention, jnp.zeros(x.shape))
    assert jx == matmuls + (JAX_EXTRA.get(policy, 0)
                            if attention == "xla" else 0)


def _kept(cfg, x, train=True):
    """The tensors the policy kept, per layer (shape, dtype), recorded from
    `remat`'s forward mode."""
    kept = []
    real = remat._contexts

    def spy(policy):
        fwd, bwd = real(policy)
        kept.append(fwd.kept)
        return fwd, bwd

    remat._contexts = spy
    try:
        torch.manual_seed(0)
        XLSREncoder(cfg).train(train)(torch.from_numpy(x).requires_grad_())
    finally:
        remat._contexts = real
    return [[(tuple(t.shape), t.dtype) for _, t in layer] for layer in kept]


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_each_policy_keeps_the_tensors_jax_names(attention):
    cfg = _cfg(attention=attention)
    B, T, d, h, f = (2, 159, cfg.encoder_embed_dim, cfg.encoder_heads,
                     cfg.encoder_ffn_dim)
    f32 = torch.float32
    proj, out4 = ((B * T, d), f32), ((B, T, h, d // h), f32)
    qk, pv = ((B * h, T, T), f32), ((B * h, T, d // h), f32)
    plain = attention == "xla"
    probs = [((B, h, T, T), f32)] if plain else []  # flash has none
    inner = pv if plain else out4
    want = {
        "dots": [proj] * 3 + ([qk, pv] if plain else [])
        + [proj, ((B * T, f), f32)],
        "attn_out": [proj],
        "attn_out_inner": [inner, proj],
        "attn_probs": probs + [inner, proj],
        "attn_all": [proj] * 3 + probs + [inner, proj],
    }
    x = _wave()
    for policy, per_layer in want.items():
        got = _kept(dataclasses.replace(cfg, remat_policy=policy), x)
        assert got == [per_layer] * cfg.encoder_layers, policy


def test_remat_is_off_outside_training_with_grad():
    """Eval mode and no_grad run no checkpoint and keep nothing."""
    cfg = _cfg("attn_all")
    x = _wave()
    assert len(_kept(cfg, x)) == cfg.encoder_layers
    assert _kept(cfg, x, train=False) == []
    with torch.no_grad():
        assert _kept(cfg, x) == []
