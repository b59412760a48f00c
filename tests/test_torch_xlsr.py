"""The port's XLSR encoder (`occm_tpu_torch.models.xlsr`) against the Flax
`XLSREncoder` at tiny dims, in fp32.

The same seeded numpy waves go through both; the Flax parameters (every one
perturbed, so a bias or LayerNorm in the wrong place shows) cross through
the port's weight bridge. The "flash" impl runs the JAX Pallas kernels in
interpret mode and the port's flash op through its plain version, as every
CPU test does. Tolerance: atol 3e-5 / rtol 1e-4, that of
tests/test_full_model_parity.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu.ops.pos_conv import pos_conv_grouped as jax_pos_conv_grouped
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models import XLSREncoder, xlsr_state_dict_from_flax
from occm_tpu_torch.ops import ffn
from occm_tpu_torch.ops.pos_conv import pos_conv_grouped
from test_torch_models import fabricated, perturbed

CUT = 3200  # tiny conv stack: 3200 samples -> 159 frames
ATOL, RTOL = 3e-5, 1e-4


def _perturbed_params(cfg: JXLSRConfig, seed: int):
    model = JXLSREncoder(cfg)
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda x: model.init(key, x))(jnp.zeros((1, CUT)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, np.shape(x)))
        .astype(np.float32), params)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("layer_norm_first", [True, False],
                         ids=["prenorm", "postnorm"])
def test_encoder_matches_flax(impl, layer_norm_first):
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), attention_impl=impl,
                               layer_norm_first=layer_norm_first)
    cfg = dataclasses.replace(XLSRConfig.tiny(), attention_impl=impl,
                              layer_norm_first=layer_norm_first)
    variables = _perturbed_params(jcfg, seed=int(layer_norm_first))
    x = (np.random.default_rng(7).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)
    want = np.asarray(JXLSREncoder(jcfg).apply(variables, jnp.asarray(x)))

    model = XLSREncoder(cfg)
    model.load_state_dict(
        xlsr_state_dict_from_flax(variables["params"], cfg), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape == (2, 159, cfg.out_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_attention_impl_argument_overrides_config():
    """One set of weights serves buckets that pick different impls: the
    forward's attention_impl wins over cfg.attention_impl, and the impls
    agree in fp32 (pad128 too, one of the JAX package's other layouts)."""
    cfg = XLSRConfig.tiny()
    torch.manual_seed(0)
    model = XLSREncoder(cfg).eval()
    x = torch.from_numpy(
        (np.random.default_rng(8).normal(size=(1, CUT)) * 0.1)
        .astype(np.float32))
    with torch.no_grad():
        a = model(x, attention_impl="xla")
        b = model(x, attention_impl="flash")
        c = model(x, attention_impl="pad128")
    torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(a, c, atol=ATOL, rtol=RTOL)


def test_pos_conv_grouped_matches_jax():
    """The port's grouped conv on torch's [B, C, T] / [C, C/G, K] layouts
    against the JAX op on [B, T, C] / [K, C/G, C], at an even kernel
    (output one frame longer; the caller crops it)."""
    rng = np.random.default_rng(9)
    b, t, c, k, g = 2, 37, 32, 16, 4
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w = rng.normal(size=(k, c // g, c)).astype(np.float32) * 0.1
    want = np.asarray(jax_pos_conv_grouped(jnp.asarray(x), jnp.asarray(w), g))
    got = pos_conv_grouped(torch.from_numpy(x).transpose(1, 2),
                           torch.from_numpy(w).permute(2, 1, 0), g)
    assert want.shape == (b, t + 1, c)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("field, value", [
    ("pp_stages", 2), ("seq_parallel", True),
    ("pos_conv_impl", "batched"), ("fused_qkv", True),
    ("attention_impl", "packed"), ("attention_impl", "pad128"),
    ("attention_impl", "xla_merged"), ("pos_conv_impl", "s2d"),
    ("attention_impl", "packed8"),
])
def test_unported_config_fields_raise(field, value):
    """Every field of the JAX config is ported. pp_stages and
    seq_parallel construct, and together they raise the JAX package's
    ValueError; each layout field gives the Flax encoder's features with
    the same field (packed8 at 8 heads, which it must divide)."""
    if field in ("pp_stages", "seq_parallel"):
        assert getattr(dataclasses.replace(XLSRConfig(), **{field: value}),
                       field) == value
        with pytest.raises(ValueError, match="seq_parallel"):
            dataclasses.replace(XLSRConfig(), pp_stages=2,
                                seq_parallel=True)
        return
    fields = {field: value}
    if value == "packed8":
        fields["encoder_heads"] = 8
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **fields)
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    x = (np.random.default_rng(10).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)
    variables = perturbed(fabricated(JXLSREncoder(
        dataclasses.replace(jcfg, attention_impl="xla")), x), seed=4)
    want = np.asarray(jax.jit(JXLSREncoder(jcfg).apply)(variables,
                                                        jnp.asarray(x)))
    model = XLSREncoder(cfg)
    model.load_state_dict(
        xlsr_state_dict_from_flax(variables["params"], cfg), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_config_matches_jax_defaults():
    """Same fields and defaults as the JAX config, for both presets."""
    for port, ref in ((XLSRConfig(), JXLSRConfig()),
                      (XLSRConfig.tiny(), JXLSRConfig.tiny())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


# ------------------------------------------------------ ffn_impl="pallas"

def _ffn_configs(**kw):
    """D 128, F 1024, 2 layers, 2 heads: widths at which the JAX package's
    fused FFN runs its Pallas kernel (interpret mode) rather than its XLA
    route."""
    dims = dict(encoder_embed_dim=128, encoder_ffn_dim=1024,
                encoder_layers=2, encoder_heads=2, ffn_impl="pallas", **kw)
    return (dataclasses.replace(JXLSRConfig.tiny(), **dims),
            dataclasses.replace(XLSRConfig.tiny(), **dims))


def _ffn_wave(seed=10):
    return (np.random.default_rng(seed).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)


def test_encoder_with_fused_ffn_matches_flax():
    jcfg, cfg = _ffn_configs()
    variables = _perturbed_params(jcfg, seed=3)
    x = _ffn_wave()
    want = np.asarray(JXLSREncoder(jcfg).apply(variables, jnp.asarray(x)))
    model = XLSREncoder(cfg)
    model.load_state_dict(
        xlsr_state_dict_from_flax(variables["params"], cfg), strict=True)
    ffn.LAUNCHES = 0
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert ffn.LAUNCHES == 0  # the CPU runs the plain version
    assert want.shape == (2, 159, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_fused_ffn_matches_the_xla_ffn_in_the_port():
    """Same weights, ffn_impl "pallas" against "xla" (tolerance of
    tests/test_xlsr_extras.py::test_ffn_impl_pallas_same_tree_and_output)."""
    _, cfg = _ffn_configs()
    torch.manual_seed(0)
    fused = XLSREncoder(cfg).eval()
    plain = XLSREncoder(dataclasses.replace(cfg, ffn_impl="xla")).eval()
    plain.load_state_dict(fused.state_dict(), strict=True)
    x = torch.from_numpy(_ffn_wave(11))
    with torch.no_grad():
        np.testing.assert_allclose(fused(x).numpy(), plain(x).numpy(),
                                   rtol=2e-3, atol=2e-5)


def test_fused_ffn_encoder_gradients_match_flax():
    """Gradients of one loss, sum of the squared features, with respect to
    every parameter, through JAX's fused-FFN custom VJP and the port's
    backward (tolerance of the gradient checks of tests/test_attention.py,
    atol 5e-4 / rtol 1e-3). Both train the positional conv's folded
    kernel, so it is held too."""
    jcfg, cfg = _ffn_configs()
    variables = _perturbed_params(jcfg, seed=4)
    x = _ffn_wave(12)
    jmodel = JXLSREncoder(jcfg)

    def loss(params):
        return jnp.sum(jmodel.apply({"params": params}, jnp.asarray(x)) ** 2)

    jgrads = jax.grad(loss)(variables["params"])
    want = xlsr_state_dict_from_flax(jgrads, cfg)
    model = XLSREncoder(cfg)
    model.load_state_dict(
        xlsr_state_dict_from_flax(variables["params"], cfg), strict=True)
    (model.train()(torch.from_numpy(x)) ** 2).sum().backward()
    grads = dict(model.named_parameters())
    # both train the positional conv's folded kernel: the bridge's
    # weight_v of a gradient tree is that kernel's gradient
    want["encoder.pos_conv.0.weight"] = want.pop("encoder.pos_conv.0.weight_v")
    want.pop("encoder.pos_conv.0.weight_g")
    checked = 0
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), w.numpy(),
                                   atol=5e-4, rtol=1e-3, err_msg=name)
        checked += 1
    assert checked == len(grads)


def test_fused_ffn_refuses_activation_dropout_in_train_mode():
    """As in JAX (models/xlsr.py:465-470): the fused FFN never materialises
    its hidden activation, so train mode with activation_dropout raises;
    eval mode runs."""
    _, cfg = _ffn_configs(activation_dropout=0.1)
    torch.manual_seed(0)
    model = XLSREncoder(cfg)
    x = torch.from_numpy(_ffn_wave(13))
    with pytest.raises(ValueError, match="activation_dropout"):
        model.train()(x)
    with torch.no_grad():
        assert torch.isfinite(model.eval()(x)).all()
