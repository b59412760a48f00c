"""The wav2vec2-base frontend in the port (`XLSRConfig.base()`: the
group-norm extractor, `extractor_mode="default"`, with bias-free convs in
its checkpoints, and the post-norm encoder) against the JAX package, at
the base layout with the tiny widths:
`dataclasses.replace(XLSRConfig.tiny(), extractor_mode="default",
layer_norm_first=False)`. The JAX variables are drawn on the host
(`test_torch_models.fabricated`), not initialised.

- the encoder's features, plain and with the kernels' routes (flash
  attention, the LayerNorm kernel behind the post-norm residuals, the fused
  FFN), at atol 3e-5 / rtol 1e-4 (tests/test_torch_xlsr.py's);
- the gradients of a fixed readout with respect to the wave and every
  parameter at atol 5e-4 / rtol 1e-3 (tests/test_attention.py's);
- the bridge both ways with the exporter's bias-free convs, strictly;
- fairseq and HF base-layout checkpoints (the HF one from
  `transformers.Wav2Vec2Model`) through `convert_xlsr`;
- `XLSRConfig.base()` field by field, and its full-width bf16 forward on
  the meta device;
- one train step of the tiny AModel on this layout against JAX's, held as
  tests/test_torch_models_train.py holds its steps (the gradient within
  5e-2 of its norm).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import RawBoostConfig as JRawBoostConfig
from occm_tpu.config import TrainConfig as JTrainConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.convert_backend import (
    export_amodel_state_dict, export_xlsr_state_dict)
from occm_tpu.models.convert_xlsr import (
    convert_fairseq_state_dict, convert_hf_state_dict)
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu.train.loop import make_optimizer as j_make_optimizer
from occm_tpu.train.loop import make_train_step
from occm_tpu.train.state import TrainState as JTrainState
from occm_tpu_torch.config import (
    AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
from occm_tpu_torch.models import (
    AModel, XLSREncoder, state_dict_from_flax, xlsr_state_dict_from_flax)
from occm_tpu_torch.models.convert import (
    detect_model_kind, load_reference_state_dict, xlsr_arrays_from_flax)
from occm_tpu_torch.models.convert_xlsr import (
    graft_pretrained_xlsr, hf_to_fairseq_names)
from occm_tpu_torch.train import create_train_state, train_step
from test_torch_convert_xlsr import _write_safetensors
from test_torch_models import fabricated, perturbed

CUT = 3200
ATOL, RTOL = 3e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
LR = 1e-3
STEP_GRAD_RTOL = 5e-2  # tests/test_torch_models_train.py's GRAD_RTOL
LAYOUT = dict(extractor_mode="default", layer_norm_first=False)
KERNELS = dict(attention_impl="flash", ln_impl="pallas", ffn_impl="pallas")
CFG = dataclasses.replace(XLSRConfig.tiny(), **LAYOUT)
JCFG = dataclasses.replace(JXLSRConfig.tiny(), **LAYOUT)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wave(seed=7, n=2):
    return (np.random.default_rng(seed).normal(size=(n, CUT)) * 0.1).astype(
        np.float32)


@pytest.fixture(scope="module")
def params():
    """Encoder parameters at Flax's init scales, every one perturbed (the
    conv biases too, so a bias in the wrong place shows)."""
    return perturbed(fabricated(JXLSREncoder(JCFG), _wave()))["params"]


def _jax_features(cfg, params, x):
    return jax.jit(lambda p, x: JXLSREncoder(cfg).apply({"params": p}, x))(
        params, jnp.asarray(x))


def _port(cfg, params):
    model = XLSREncoder(cfg).eval()
    model.load_state_dict(xlsr_state_dict_from_flax(params, cfg),
                          strict=True)
    return model


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_encoder_features_match_jax(params, kernels):
    kw = KERNELS if kernels else {}
    cfg = dataclasses.replace(CFG, **kw)
    x = _wave()
    want = np.asarray(_jax_features(dataclasses.replace(JCFG, **kw), params,
                                    x))
    model = _port(cfg, params)
    assert isinstance(model.feature_extractor.conv_layers[0]["2"],
                      torch.nn.GroupNorm)
    assert all("2" not in layer
               for layer in model.feature_extractor.conv_layers[1:])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 159, CFG.out_dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_gradients_match_jax(params):
    """d/d(wave, params) of sum(features * proj), every kernel's route."""
    cfg = dataclasses.replace(CFG, **KERNELS)
    jcfg = dataclasses.replace(JCFG, **KERNELS)
    x = _wave(11)
    proj = np.random.default_rng(12).normal(
        size=(CFG.out_dim,)).astype(np.float32)

    def readout(p, w):
        return jnp.sum(JXLSREncoder(jcfg).apply({"params": p}, w)
                       * jnp.asarray(proj))

    jgp, jgx = jax.jit(jax.grad(readout, argnums=(0, 1)))(params,
                                                         jnp.asarray(x))
    model = _port(cfg, params)
    xt = torch.from_numpy(x).requires_grad_()
    (model(xt) * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    want = xlsr_arrays_from_flax(jax.tree_util.tree_map(np.asarray, jgp),
                                 cfg)
    pos = "encoder.pos_conv.0."
    want[pos + "weight"] = want.pop(pos + "weight_v")  # the folded kernel
    want.pop(pos + "weight_g")
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert "feature_extractor.conv_layers.0.2.weight" in got
    # block 0's conv bias feeds a GroupNorm with a group per channel,
    # which removes it: its gradient is zero but for rounding, on both
    # sides (~1e-7 of the largest), so it is held to that
    top = max(float(g.abs().max()) for g in got.values())
    noise = "feature_extractor.conv_layers.0.0.bias"
    for g in (got.pop(noise).numpy(), want[noise]):
        assert np.abs(g).max() <= 1e-6 * top
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_bridge_round_trip_with_bias_free_convs(tmp_path):
    """Flax's zero conv biases, which the JAX exporter drops (the layout
    of a bias-free wav2vec2-base checkpoint), load strictly into the port
    (as zeros), and the port's state dict converts back to the same
    parameters; the same for an AModel file through
    load_reference_state_dict and detect_model_kind."""
    variables = fabricated(JAModel(JAASISTConfig.tiny(), xlsr_cfg=JCFG),
                           np.zeros((2, CUT), np.float32))
    jparams = variables["params"]["ssl_model"]
    exported = export_xlsr_state_dict(jparams, JCFG)
    conv_biases = [k for k in exported
                   if k.startswith("feature_extractor.")
                   and k.endswith(".0.bias")]
    assert conv_biases == []
    assert "feature_extractor.conv_layers.0.2.weight" in exported
    assert detect_model_kind(exported) == "ssl"
    model = XLSREncoder(CFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in exported.items()}, strict=True)
    for layer in model.feature_extractor.conv_layers:
        assert not layer["0"].bias.any()
    back = convert_fairseq_state_dict(model.state_dict(), JCFG)
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(jparams))
    got = dict(flat(back))
    assert got.keys() == want.keys()
    for path, w in want.items():
        rtol = 2e-6 if "pos_conv" in jax.tree_util.keystr(path) else 0
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=0,
                                   err_msg=jax.tree_util.keystr(path))

    amodel = export_amodel_state_dict(variables, JCFG)
    path = tmp_path / "aasist_vocoded_0.pt"
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in amodel.items()}}, path)
    state = load_reference_state_dict(str(path))
    assert detect_model_kind(state) == "amodel"
    port = AModel(AASISTConfig.tiny(), CFG)
    port.load_state_dict(state, strict=True)
    bridged = state_dict_from_flax(variables, CFG)
    for k, v in port.state_dict().items():  # the fold: a few ulps
        rtol = 2e-6 if ".pos_conv.0.weight" in k else 0
        torch.testing.assert_close(v, bridged[k], rtol=rtol, atol=0,
                                   msg=k)


@pytest.fixture(scope="module")
def hf_base():
    """A random transformers.Wav2Vec2Model in the base layout at the tiny
    widths (conv_bias=False, group-norm extractor, post-norm encoder)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # torch's model only: skip TensorFlow
        transformers = pytest.importorskip("transformers")
        from test_xlsr_hf_oracle import _hf_config

    torch.manual_seed(0)
    model = transformers.Wav2Vec2Model(_hf_config(JCFG)).eval()
    assert model.config.feat_extract_norm == "group"
    assert not model.config.do_stable_layer_norm
    return model


@pytest.mark.parametrize("fmt", ["fairseq", "hf"])
def test_base_checkpoints_graft_and_match_jax(tmp_path, hf_base, fmt):
    sd = hf_base.state_dict()
    assert not any(k.startswith("feature_extractor.")
                   and k.endswith("conv.bias") for k in sd)
    if fmt == "hf":
        path = tmp_path / "model.safetensors"
        _write_safetensors(path, {k: v.numpy() for k, v in sd.items()})
    else:
        fairseq = hf_to_fairseq_names(sd, CFG)
        assert "feature_extractor.conv_layers.0.2.weight" in fairseq
        assert "encoder.layer_norm.weight" in fairseq
        path = tmp_path / "wav2vec_small.pt"
        torch.save({"model": {"w2v_model." + k: v
                              for k, v in fairseq.items()}}, path)
    encoder = XLSREncoder(CFG).eval()
    graft_pretrained_xlsr(encoder, str(path))
    x = _wave(13)
    with torch.no_grad():
        got = encoder(torch.from_numpy(x)).numpy()
        theirs = hf_base(torch.from_numpy(x)).last_hidden_state.numpy()
    jparams = convert_hf_state_dict(
        {k: v.numpy() for k, v in sd.items()}, JCFG)
    want = np.asarray(_jax_features(JCFG, jparams, x))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the JAX oracle test's bound against HF (test_xlsr_hf_oracle.py)
    np.testing.assert_allclose(got, theirs, atol=2e-4)


def test_base_config_equals_jax():
    assert dataclasses.asdict(XLSRConfig.base()) == dataclasses.asdict(
        JXLSRConfig.base())


def test_base_forward_on_meta_in_bf16():
    """XLSRConfig.base() at full width, bf16 (its default dtype), on the
    meta device: every layer hands the next a bf16 [2, 49, 768] (the
    post-norm LayerNorms' fp32 outputs cast back), and the encoder ends
    at [2, 49, 768] fp32 as JAX's does (test_base_preset_traces_in_bf16)."""
    cfg = XLSRConfig.base()
    with torch.device("meta"):
        model = XLSREncoder(cfg).eval()
    assert sum(p.numel() for p in model.parameters()) == 94_374_400
    outs = []
    for layer in model.encoder.layers:
        layer.register_forward_hook(lambda m, a, y: outs.append(y))
    y = model(torch.empty((2, 16000), device="meta"))
    assert len(outs) == 12
    assert all(o.dtype == torch.bfloat16 and o.shape == (2, 49, 768)
               for o in outs)
    assert y.shape == (2, 49, 768) and y.dtype == torch.float32


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step of the tiny AModel on the base layout (adam,
    every kernel's route, AASIST's dropout off) from fabricated weights."""
    jx = dataclasses.replace(JCFG, **KERNELS)
    ja = dataclasses.replace(JAASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    cfg = JTrainConfig(lr=LR, cut=CUT, compactness_weight=0.1,
                       descriptiveness_weight=0.9,
                       rawboost=JRawBoostConfig(algo=0))
    model = JAModel(ja, xlsr_cfg=jx)
    x = _wave(14, n=12)
    variables = jax.tree_util.tree_map(jnp.asarray, perturbed(
        fabricated(model, x), seed=3))
    tx, _ = j_make_optimizer(cfg)
    state0 = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx, apply_fn=model.apply)
    snap = lambda s: jax.tree_util.tree_map(np.asarray, s)  # noqa: E731
    s0 = snap(state0)
    labels = np.array([0] * 6 + [1] * 6, np.int32)
    state1, m1 = make_train_step(cfg)(
        state0, (jnp.asarray(x), jnp.asarray(labels)), jax.random.PRNGKey(1))
    return dict(x=x, labels=labels, s0=s0, s1=snap(state1),
                loss=float(m1["loss"]))


def test_train_step_matches_jax(jax_step):
    px = dataclasses.replace(CFG, **KERNELS)
    pa = dataclasses.replace(AASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    s0, s1 = jax_step["s0"], jax_step["s1"]

    def by_name(tree, s):
        sd = state_dict_from_flax({"params": tree,
                                   "batch_stats": s.batch_stats}, px)
        return {(k[:-2] if k.endswith("pos_conv.0.weight_v") else k):
                v.double() for k, v in sd.items()}

    model = AModel(pa, px)
    model.load_state_dict(state_dict_from_flax(
        {"params": s0.params, "batch_stats": s0.batch_stats}, px),
        strict=True)
    cfg = TrainConfig(lr=LR, cut=CUT, compactness_weight=0.1,
                      descriptiveness_weight=0.9,
                      rawboost=RawBoostConfig(algo=0))
    state = create_train_state(model, cfg)
    x = torch.from_numpy(jax_step["x"])
    labels = torch.from_numpy(jax_step["labels"]).long()
    before = {n: p.detach().double().clone()
              for n, p in model.named_parameters()}
    metrics = train_step(state, x, labels, cfg)
    assert float(metrics["loss"]) == pytest.approx(jax_step["loss"],
                                                   rel=1e-5)
    # Adam's first step: m = 0.1 g, so each side's gradient is 10 m; the
    # port's is read from its update, p1 = p0 - lr * m / (sqrt(v) + eps)
    opt = state.optimizer.state
    mu = by_name(s1.opt_state[0].mu, s1)
    want_p = by_name(s1.params, s1)
    grads = {n: (10 * opt[p]["exp_avg"].double(), 10 * mu[n])
             for n, p in model.named_parameters() if p in opt}
    top = max(float(gj.abs().max()) for _, gj in grads.values())
    num = den = 0.0
    for g, g_jax in grads.values():
        keep = g_jax.abs() >= 1e-6 * top
        num += float((g - g_jax)[keep].square().sum())
        den += float(g_jax[keep].square().sum())
    assert den > 0 and num <= STEP_GRAD_RTOL ** 2 * den, (num / den) ** 0.5
    for name, p in model.named_parameters():
        p = p.detach().double()
        assert float((p - want_p[name]).abs().max()) <= 2 * LR + 1e-6, name
        assert float((p - before[name]).abs().max()) <= LR * 1.01 + 1e-6
