"""The JAX package's other layouts of the XLSR encoder in the port
(`occm_tpu_torch.models.xlsr`, `occm_tpu_torch.ops.pos_conv`): `fused_qkv`,
`attention_impl` packed[N] / pad128 / xla_merged / skip and `pos_conv_impl`
batched / s2d, at `XLSRConfig.tiny()` (fp32; packed8 at 8 heads), torch
pinned to one thread.

- Each layout against the Flax encoder with the same fields (variables
  fabricated on the host and perturbed, as tests/test_torch_models.py
  does): forward at rtol 1e-4 / atol 1e-5, the JAX suite's tolerance for
  these layouts (tests/test_xlsr_extras.py:231-234); every parameter's
  gradient of sum(features^2) at rtol 1e-3 / atol 1e-4, its tolerance for
  the positional conv's kernel gradient (:319-324), which is the widest
  of the three.
- Each layout against the port's default layout (xla, grouped) in train
  mode with every dropout site on and one generator: the masks are laid
  out as each layout's tensors are, so the two agree at the same
  tolerances.
- Every remat policy under each layout gives that layout's numbers
  without remat bit for bit.
- JAX's validation and errors on both sides: the impl names, "skip" only
  with allow_debug_impls, a pack width that does not divide the heads.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models import XLSREncoder, remat, xlsr_state_dict_from_flax
from test_torch_models import fabricated, perturbed

CUT = 3200  # tiny conv stack: 159 frames
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
POLICIES = ("nothing", "dots", "attn_out", "attn_out_inner", "attn_probs",
            "attn_all")
#: layout id -> the XLSRConfig fields that select it
LAYOUTS = {
    "fused_qkv": dict(fused_qkv=True),
    "fused_qkv_flash": dict(fused_qkv=True, attention_impl="flash"),
    "packed": dict(attention_impl="packed"),
    "packed4": dict(attention_impl="packed4"),
    "packed8": dict(attention_impl="packed8", encoder_heads=8),
    "pad128": dict(attention_impl="pad128"),
    "xla_merged": dict(attention_impl="xla_merged"),
    "pos_batched": dict(pos_conv_impl="batched"),
    "pos_s2d": dict(pos_conv_impl="s2d"),
}
DROPOUT = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
               dropout_input=0.1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wave(seed=3, batch=2):
    return (np.random.default_rng(seed).normal(size=(batch, CUT))
            * 0.1).astype(np.float32)


def _default(fields):
    """The default layout's fields of a layout's model (its head count
    kept; flash kept under fused_qkv_flash, whose default is flash)."""
    base = {k: v for k, v in fields.items() if k == "encoder_heads"}
    if fields.get("attention_impl") == "flash":
        base["attention_impl"] = "flash"
    return base


def _port_run(fields, x, state=None, gen_seed=None):
    """(features, {name: gradient}) of one backward of sum(features^2):
    eval-mode weights from seed 0 (or `state`); train mode with one
    generator when gen_seed is given."""
    torch.manual_seed(0)
    model = XLSREncoder(dataclasses.replace(XLSRConfig.tiny(), **fields))
    if state is not None:
        model.load_state_dict(state, strict=True)
    gen = None
    if gen_seed is not None:
        model.train()
        gen = torch.Generator().manual_seed(gen_seed)
    else:
        model.eval()
    y = model(torch.from_numpy(x), generator=gen)
    (y ** 2).sum().backward()
    return y.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_flax(layout):
    fields = LAYOUTS[layout]
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **fields)
    x = _wave(seed=5)
    variables = perturbed(fabricated(JXLSREncoder(jcfg), x),
                          list(LAYOUTS).index(layout))
    jmodel = JXLSREncoder(jcfg)

    def loss(params):
        y = jmodel.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(y ** 2), y

    (_, want_y), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    got_y, got_g = _port_run(fields, x, xlsr_state_dict_from_flax(
        variables["params"], cfg))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    want = xlsr_state_dict_from_flax(jgrads, cfg)
    # both train the positional conv's folded kernel: the bridge's
    # weight_v of a gradient tree is that kernel's gradient
    want["encoder.pos_conv.0.weight"] = want.pop("encoder.pos_conv.0.weight_v")
    want.pop("encoder.pos_conv.0.weight_g")
    assert want.keys() == got_g.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got_g[n].numpy(), w.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)


@pytest.mark.parametrize("layout", [k for k in LAYOUTS
                                    if "flash" not in k])
def test_layout_matches_the_default_layout_with_dropout(layout):
    """One generator, every dropout site: the same masks reach each
    layout's tensors, so the layout and xla / grouped agree."""
    fields = LAYOUTS[layout]
    x = _wave(seed=6)
    want_y, want_g = _port_run(dict(_default(fields), **DROPOUT), x,
                               gen_seed=11)
    got_y, got_g = _port_run(dict(fields, **DROPOUT), x, gen_seed=11)
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for n, w in want_g.items():
        np.testing.assert_allclose(got_g[n].numpy(), w.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)


@pytest.mark.parametrize("policy", POLICIES[1:])
@pytest.mark.parametrize("layout", list(LAYOUTS) + ["skip"])
def test_remat_policy_under_layout_gives_the_numbers_of_nothing(
        layout, policy, monkeypatch):
    """Each policy keeps what the layout names (models/remat.py) and
    recomputes the rest: the features and every gradient (the wave's
    too) bit for bit with the policy "nothing", and with no remat. Under
    attn_probs and attn_all a plain layout keeps its softmax."""
    fields = (dict(attention_impl="skip", allow_debug_impls=True)
              if layout == "skip" else LAYOUTS[layout])
    kept = []
    contexts = remat._contexts

    def spy(policy):
        keep, replay = contexts(policy)
        kept.append(keep.kept)
        return keep, replay

    monkeypatch.setattr(remat, "_contexts", spy)
    x = _wave()
    runs = {}
    for name, knobs in (("none", dict(remat=False)),
                        ("nothing", dict(remat=True)),
                        (policy, dict(remat=True, remat_policy=policy))):
        torch.manual_seed(0)
        cfg = dataclasses.replace(XLSRConfig.tiny(), **fields, **knobs)
        model = XLSREncoder(cfg).train()
        wave = torch.from_numpy(x).requires_grad_()
        y = model(wave, generator=torch.Generator().manual_seed(2))
        (y ** 2).sum().backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        grads["wave"] = wave.grad
        runs[name] = (y.detach(), grads)
    want_y, want_g = runs["none"]
    for name in ("nothing", policy):
        got_y, got_g = runs[name]
        assert torch.equal(got_y, want_y), name
        assert got_g.keys() == want_g.keys()
        for n, g in want_g.items():
            if g is None:  # skip: q and k take no gradient
                assert got_g[n] is None, (name, n)
            else:
                assert torch.equal(got_g[n], g), (name, n)
    ops = {func for layer in kept for func, _ in layer}
    plain = layout != "skip" and "flash" not in layout
    if plain and policy in ("attn_probs", "attn_all"):
        assert torch.ops.aten._softmax.default in ops, ops
    assert ops, "the policy kept nothing"


def test_skip_passes_v_through_as_jax_does():
    """attention_impl="skip" on both sides, allowed only with
    allow_debug_impls, the forward against Flax's."""
    fields = dict(attention_impl="skip", allow_debug_impls=True)
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **fields)
    x = _wave(seed=7)
    variables = perturbed(fabricated(JXLSREncoder(jcfg), x), 3)
    want = np.asarray(jax.jit(JXLSREncoder(jcfg).apply)(variables,
                                                        jnp.asarray(x)))
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    model = XLSREncoder(cfg).eval()
    model.load_state_dict(xlsr_state_dict_from_flax(variables["params"],
                                                    cfg), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("fields, error, match", [
    (dict(attention_impl="skip"), ValueError, "allow_debug_impls"),
    (dict(attention_impl="falsh"), ValueError, "unknown attention_impl"),
    (dict(attention_impl="packedX"), ValueError, "unknown attention_impl"),
    (dict(pos_conv_impl="dense"), ValueError, "unknown pos_conv_impl"),
    (dict(ffn_impl="fused"), ValueError, "unknown ffn_impl"),
    (dict(remat_policy="everything"), ValueError, "unknown remat_policy"),
    (dict(dtype="float16"), ValueError, "unknown dtype"),
], ids=["skip", "falsh", "packedX", "pos_conv", "ffn", "remat", "dtype"])
def test_impl_knobs_validated_at_config_as_jax(fields, error, match):
    """tests/test_xlsr_extras.py:270 on both configs."""
    for make in (JXLSRConfig.tiny, XLSRConfig.tiny):
        with pytest.raises(error, match=match):
            dataclasses.replace(make(), **fields)
    for impl in ("xla", "xla_merged", "packed", "packed2", "packed8",
                 "pad128", "flash"):
        assert dataclasses.replace(XLSRConfig.tiny(),
                                   attention_impl=impl).attention_impl == impl


@pytest.mark.parametrize("impl", ["packed8", "packed3"])
def test_pack_width_that_does_not_divide_the_heads_raises_as_jax(impl):
    """tiny's 4 heads: JAX raises at apply, and so does the port, naming
    the width and the heads."""
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), attention_impl=impl)
    x = _wave(batch=1)
    variables = fabricated(JXLSREncoder(JXLSRConfig.tiny()), x)
    with pytest.raises(ValueError, match="pack width"):
        JXLSREncoder(jcfg).apply(variables, jnp.asarray(x))
    model = XLSREncoder(dataclasses.replace(XLSRConfig.tiny(),
                                            attention_impl=impl))
    width = impl[len("packed"):]
    with pytest.raises(ValueError,
                       match=f"pack width {width} .*num_heads=4"):
        model.eval()(torch.from_numpy(x))


@pytest.mark.parametrize("impl", ["xla_merged", "packed", "pad128"])
def test_plain_layouts_take_attention_dropout_and_flash_refuses_it(impl):
    """As in JAX (tests/test_xlsr_extras.py:380-402): only the flash
    kernel refuses attention dropout in train mode."""
    x = torch.from_numpy(_wave(batch=1))
    rate = dict(attention_dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    model = XLSREncoder(dataclasses.replace(
        XLSRConfig.tiny(), attention_impl=impl, **rate)).train()
    assert torch.isfinite(model(x, generator=gen)).all()
    flash = XLSREncoder(dataclasses.replace(
        XLSRConfig.tiny(), attention_impl="flash", fused_qkv=True,
        **rate)).train()
    with pytest.raises(ValueError, match="flash"):
        flash(x, generator=gen)
