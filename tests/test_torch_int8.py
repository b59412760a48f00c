"""W8A8 int8 scoring and serving in the port (`occm_tpu_torch.ops.int8`,
`XLSRConfig.quant_int8`, `--quant_int8` in `oc_classifier` and
`oc_server`) against the JAX package on the CPU at tiny dims. The JAX
variables are fabricated on the host from jax.eval_shape and perturbed
(tests/test_torch_models.py), so nothing is compiled for them.

Tolerances:
- `quantize_weight_int8`, and `int8_matmul`'s x_q and int32 accumulator:
  equal bit for bit (integers, from the same fp32 operations);
- `int8_matmul`'s y: rtol 1e-6, the JAX suite's (tests/test_int8.py);
- the tiny encoder against JAX's `quant_int8=True` apply: a flip of one
  `round` upstream (two sums that agree to 1e-7 on either side of a .5)
  moves a projection's output by one int8 step, s_x * w_scale, about
  1/127 of that row's largest value, and the flip travels on. In fp32
  compute the outputs stay within 4e-3 relative L2 (measured 7e-4 to
  8e-4, a tenth of the int8 error itself); with bf16 compute or norms
  within 2 % relative L2, the bound of the port's fast-numerics tests
  (tests/test_torch_fast_numerics.py), where bf16 roundings of the two
  packages differ anyway (measured 1.0-1.3 %);
- scores of the CLIs against the JAX scorer on the same quantised
  weights: rtol 0.02 (tests/test_torch_fast_numerics.py:200), a distance
  also within 0.02 of the reference embedding's norm (a distance between
  nearly equal vectors carries the embeddings' error, not its own,
  tests/test_torch_classifier_cli.py); the 1c reference embedding, a
  mean of AASIST embeddings, within 5 % relative L2: AASIST's top-k
  graph pooling turns a flipped rounding into another choice of nodes
  (measured: 5e-7 in fp32, 0.2 % for SSLResNet34 and 2.9 % for AModel
  under fast numerics, where the int8 roundings follow bf16 ones).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import occm_tpu.ops.int8 as jint8
from occm_tpu.classify import BucketedEmbedder as JBucketedEmbedder
from occm_tpu.classify import OneClassScorer as JOneClassScorer
from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.data import ASVDataset as JASVDataset
from occm_tpu.io.scorefiles import read_comma_scores
from occm_tpu.models import OCCM as JOCCM
from occm_tpu.models import SSLLCNN as JSSLLCNN
from occm_tpu.models import SSLResNet34 as JSSLResNet34
from occm_tpu.models import AModel as JAModel
from occm_tpu.models import TotalCNNNet as JTotalCNNNet
from occm_tpu.models import XLSREncoder as JXLSREncoder
from occm_tpu.serve import ScoringService as JScoringService
from occm_tpu.serve import make_score_fn as jmake_score_fn
from occm_tpu.serve import make_score_fn_v
from occm_tpu_torch import models
from occm_tpu_torch.cli import oc_classifier, oc_server
from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.io.wav import write_wav
from occm_tpu_torch.models import state_dict_from_flax
from occm_tpu_torch.models import xlsr as pxlsr
from occm_tpu_torch.models import xlsr_state_dict_from_flax
from occm_tpu_torch.ops import int8
from test_torch_models import fabricated, perturbed

CUT = 3200
SR = 16000
FAST = dict(norm_dtype="bfloat16", gelu_approximate=True,
            conv_gelu_approximate=True, bf16_param_mirror=True)
FP32_REL = 4e-3
BF16_REL = 0.02
SCORE_RTOL = 0.02
REF_REL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch ops run on one thread (tiny models; the suite's
    workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wave(seed=1, batch=2, n=CUT):
    return (np.random.default_rng(seed).normal(size=(batch, n))
            * 0.1).astype(np.float32)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- the op

@pytest.mark.parametrize("shape, zero_row", [
    ((48, 40), False), ((128, 64), True), ((24, 4096), False)])
def test_quantize_weight_matches_jax(shape, zero_row):
    """q and scale bit for bit; JAX's layout is [in, out], the port's
    nn.Linear's [out, in]. An all-zero channel takes the 1e-12 floor."""
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    if zero_row:
        w[3] = 0.0
    q, scale = int8.quantize_weight_int8(torch.from_numpy(w))
    jq, jscale = jint8.quantize_weight_int8(w.T)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq.T)
    np.testing.assert_array_equal(scale.numpy(), jscale)
    assert int(q.abs().max()) == 127


def _jax_parts(monkeypatch, x, wq_t, scale, bias):
    """JAX's int8_matmul on numpy inputs, with the x_q and int32 product
    its dot_general saw and made."""
    seen = {}
    dot = jax.lax.dot_general

    def recording(a, b, **kw):
        out = dot(a, b, **kw)
        seen["x_q"], seen["acc"] = np.asarray(a), np.asarray(out)
        return out

    monkeypatch.setattr(jax.lax, "dot_general", recording)
    y = jint8.int8_matmul(jnp.asarray(x), jnp.asarray(wq_t),
                          jnp.asarray(scale),
                          None if bias is None else jnp.asarray(bias))
    monkeypatch.setattr(jax.lax, "dot_general", dot)
    return np.asarray(y), seen["x_q"], seen["acc"]


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(monkeypatch, x_dtype, with_bias,
                                 param_dtype):
    """fp32 and bf16 x, with and without bias, fp32 scale and bias or the
    bf16 mirror's: x_q and acc exactly, y to rtol 1e-6."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    w = rng.normal(size=(40, 64)).astype(np.float32)
    b = rng.normal(size=40).astype(np.float32) if with_bias else None
    q, scale = int8.quantize_weight_int8(torch.from_numpy(w))
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    pdt = getattr(torch, param_dtype)
    st = scale.to(pdt)
    bt = None if b is None else torch.from_numpy(b).to(pdt)
    jx = jnp.asarray(xt.float().numpy()).astype(x_dtype)
    want_y, want_xq, want_acc = _jax_parts(
        monkeypatch, jx, q.numpy().T,
        jnp.asarray(st.float().numpy()).astype(param_dtype),
        None if bt is None else jnp.asarray(bt.float().numpy()).astype(
            param_dtype))
    y, x_q, acc = int8.int8_matmul(xt, q, st, bt, parts=True)
    assert y.shape == (3, 7, 40) and y.dtype == torch.float32
    assert x_q.dtype == torch.int8 and acc.dtype == torch.int32
    np.testing.assert_array_equal(x_q.numpy(), want_xq.reshape(-1, 64))
    np.testing.assert_array_equal(acc.numpy(), want_acc.reshape(-1, 40))
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-6, atol=1e-6)
    ref = int8.int8_matmul_reference(xt, q, st, bt, torch.bfloat16)
    assert ref.dtype == torch.bfloat16
    assert torch.equal(ref, y.to(torch.bfloat16))


def test_int8_mm_reference_is_exact_at_the_largest_sums():
    """The fp64 product is exact where the int32 accumulator is fullest:
    +-127 everywhere at K = 4096 (|acc| = 127^2 * 4096), against numpy's
    int64 product."""
    rng = np.random.default_rng(2)
    xq = (rng.choice([-127, 127], size=(5, 4096))).astype(np.int8)
    wq = (rng.choice([-127, 127], size=(24, 4096))).astype(np.int8)
    xq[0] = 127
    wq[0] = 127
    got = int8.int8_mm_reference(torch.from_numpy(xq), torch.from_numpy(wq))
    want = xq.astype(np.int64) @ wq.astype(np.int64).T
    assert got.dtype == torch.int32 and int(got[0, 0]) == 127 ** 2 * 4096
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(int8.int8_mm(torch.from_numpy(xq),
                                    torch.from_numpy(wq)), got)


def test_int8_mm_checks_its_operands():
    a = torch.zeros(4, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 operands"):
        int8.int8_mm(a.float(), a)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        int8.int8_mm(a, torch.zeros(8, 24, dtype=torch.int8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8.int8_mm(a.to("meta"), a.to("meta"))


def test_int8_matmul_counts_its_calls_and_the_encoder_makes_six_a_layer():
    cfg = dataclasses.replace(XLSRConfig.tiny(), quant_int8=True)
    model = pxlsr.XLSREncoder(cfg).eval()
    x = torch.from_numpy(_wave())
    int8.CALLS = 0
    int8.int8_matmul_reference(torch.ones(2, 8), torch.ones(
        8, 8, dtype=torch.int8), torch.ones(8))
    assert int8.CALLS == 0
    with torch.no_grad():
        model(x)
    assert int8.CALLS == 6 * cfg.encoder_layers


# ------------------------------------------------------- the weight bridge

BRIDGE_KINDS = {"amodel": lambda c: JAModel(JAASISTConfig.tiny(), xlsr_cfg=c),
                "ssl_resnet34": lambda c: JSSLResNet34(xlsr_cfg=c),
                "ssl_lcnn": lambda c: JSSLLCNN(xlsr_cfg=c),
                "cnn": lambda c: JTotalCNNNet(xlsr_cfg=c),
                "occm": lambda c: JOCCM(xlsr_cfg=c)}
PORT_KINDS = {"amodel": lambda c: models.AModel(AASISTConfig.tiny(),
                                                xlsr_cfg=c),
              "ssl_resnet34": lambda c: models.SSLResNet34(xlsr_cfg=c),
              "ssl_lcnn": lambda c: models.SSLLCNN(xlsr_cfg=c),
              "cnn": lambda c: models.TotalCNNNet(xlsr_cfg=c),
              "occm": lambda c: models.OCCM(xlsr_cfg=c)}


@pytest.mark.parametrize("kind", sorted(BRIDGE_KINDS))
def test_bridge_carries_jax_quant_tree(kind):
    """JAX's `quantize_params_int8` tree bridges into the port's int8 model
    with strict=True, and equals the port's `quantize_state_dict_int8` of
    the bridged fp32 dict bit for bit. The backends' own fc1 / fc2 (and
    every other backend tensor) stay as the fp32 dict has them."""
    jvars = perturbed(fabricated(BRIDGE_KINDS[kind](JXLSRConfig.tiny()),
                                 _wave()))
    qvars = dict(jvars, params=jint8.quantize_params_int8(jvars["params"]))
    cfg = dataclasses.replace(XLSRConfig.tiny(), quant_int8=True)
    bridged = state_dict_from_flax(qvars, cfg)
    fp32 = state_dict_from_flax(jvars, XLSRConfig.tiny())
    ours = int8.quantize_state_dict_int8(fp32)
    assert set(ours) == set(bridged)
    for k, v in bridged.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    quantised = {k for k in bridged if k.endswith(".weight_q")}
    assert len(quantised) == 6 * cfg.encoder_layers
    assert all(".encoder.layers." in k for k in quantised)
    # the backends' fully connected layers: fc1 / fc2 of the CNN heads and
    # LCNN, SE-ResNet's squeeze-excite se.fc (Flax's se/fc1, se/fc2)
    backend_fc = [k for k in fp32 if ".fc" in k and ".encoder." not in k]
    assert bool(backend_fc) == (kind != "amodel"), kind
    for k in backend_fc:
        assert ours[k] is fp32[k] and bridged[k].dtype == torch.float32
    PORT_KINDS[kind](cfg).load_state_dict(bridged, strict=True)


def test_mirror_rounds_scale_and_bias_and_leaves_weight_q(monkeypatch):
    """Under the bf16 mirror the int8 projections read weight_q int8 and
    scale / bias rounded to bf16: JAX's (recorded in jax.eval_shape of
    its apply) and the port's (recorded in a forward) alike, the port's
    equal to the fp32 parameters cast by hand bit for bit."""
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), quant_int8=True, **FAST)
    cfg = dataclasses.replace(XLSRConfig.tiny(), quant_int8=True, **FAST)
    x = _wave()
    jvars = perturbed(fabricated(JXLSREncoder(
        dataclasses.replace(jcfg, quant_int8=False)), x))
    qparams = jint8.quantize_params_int8(jvars["params"])
    jseen, seen = [], []
    jmatmul = jint8.int8_matmul

    def jrecord(x, w, s, b, out_dtype=jnp.float32):
        jseen.append((x.dtype, w.dtype, s.dtype, b.dtype))
        return jmatmul(x, w, s, b, out_dtype)

    monkeypatch.setattr(jint8, "int8_matmul", jrecord)
    jax.eval_shape(lambda p, x: JXLSREncoder(jcfg).apply({"params": p}, x),
                   qparams, jnp.asarray(x))
    matmul = pxlsr.int8_matmul

    def record(x, w, s, b, out_dtype=torch.float32):
        seen.append((w, s, b))
        return matmul(x, w, s, b, out_dtype)

    monkeypatch.setattr(pxlsr, "int8_matmul", record)
    model = pxlsr.XLSREncoder(cfg).eval()
    model.load_state_dict(xlsr_state_dict_from_flax(qparams, cfg),
                          strict=True)
    with torch.no_grad():
        model(torch.from_numpy(x))
    # the scan body is traced once for all layers
    assert {d[1:] for d in jseen} == {(jnp.dtype(jnp.int8),
                                       jnp.dtype(jnp.bfloat16),
                                       jnp.dtype(jnp.bfloat16))}
    assert len(seen) == 6 * cfg.encoder_layers
    params = dict(model.named_parameters())
    names = [f"encoder.layers.{l}.{m}" for l in range(cfg.encoder_layers)
             for m in ("self_attn.q_proj", "self_attn.k_proj",
                       "self_attn.v_proj", "self_attn.out_proj", "fc1",
                       "fc2")]
    for (w, s, b), name in zip(seen, names):
        assert w is params[name + ".weight_q"]
        assert s.dtype == b.dtype == torch.bfloat16
        assert torch.equal(s, params[name + ".scale"].to(torch.bfloat16))
        assert torch.equal(b, params[name + ".bias"].to(torch.bfloat16))


# ------------------------------------------------------------ the encoder

ENCODERS = {
    "tiny": ({}, FP32_REL),
    "post_norm": (dict(layer_norm_first=False), FP32_REL),
    "fast": (FAST, BF16_REL),
    "post_norm_bf16": (dict(layer_norm_first=False, dtype="bfloat16"),
                       BF16_REL),
    "bf16_fast": (dict(FAST, dtype="bfloat16"), BF16_REL),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_int8_encoder_matches_jax(name):
    """The tiny encoder with quant_int8 on JAX's quantised tree against
    JAX's quant_int8=True apply: pre-norm fp32 (tiny itself), post-norm
    (wav2vec2-base's layout) in fp32 and in bf16 under exact numerics,
    and fast numerics in fp32 and bf16 compute (XLS-R's int8 config).
    Beside it, the port's int8 output against its own fp32 one within the
    JAX suite's bounds (tests/test_int8.py: cosine 0.99, relative L2
    0.15)."""
    fields, rel_bound = ENCODERS[name]
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **fields)
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    x = _wave()
    jvars = perturbed(fabricated(JXLSREncoder(jcfg), x))
    qparams = jint8.quantize_params_int8(jvars["params"])
    jq = JXLSREncoder(dataclasses.replace(jcfg, quant_int8=True))
    want = np.asarray(jax.jit(lambda p, x: jq.apply({"params": p}, x))(
        qparams, jnp.asarray(x)))
    qcfg = dataclasses.replace(cfg, quant_int8=True)
    model = pxlsr.XLSREncoder(qcfg).eval()
    model.load_state_dict(xlsr_state_dict_from_flax(qparams, qcfg),
                          strict=True)
    fp32 = pxlsr.XLSREncoder(cfg).eval()
    fp32.load_state_dict(xlsr_state_dict_from_flax(jvars["params"], cfg),
                         strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        ref = fp32(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    rel = _rel(got, want)
    assert rel <= rel_bound, f"{name}: relative L2 to JAX {rel}"
    cos = float(got.ravel() @ ref.ravel()
                / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos >= 0.99 and _rel(got, ref) <= 0.15, (cos, _rel(got, ref))


def test_activation_dropout_refused_in_training():
    """JAX's train-time refusal (models/xlsr.py:466-470): the int8 FFN
    never materialises the hidden activation for activation_dropout."""
    cfg = dataclasses.replace(XLSRConfig.tiny(), quant_int8=True,
                              activation_dropout=0.1)
    model = pxlsr.XLSREncoder(cfg).train()
    with pytest.raises(ValueError, match="quant_int8"):
        model(torch.from_numpy(_wave()))


# ------------------------------------------------------------ the refusal

REFUSAL = {
    # name: (fields on XLSRConfig(quant_int8=True), refused)
    "exact": ({}, True),
    "exact_mirror": (dict(bf16_param_mirror=True), True),
    "exact_ln_pallas": (dict(ln_impl="pallas"), False),
    "fast": (FAST, False),
    "fp32_bf16_norms": (dict(dtype="float32", norm_dtype="bfloat16"),
                        False),
    "base": (dict(extractor_mode="default", layer_norm_first=False,
                  encoder_layers=12, encoder_embed_dim=768,
                  encoder_ffn_dim=3072, encoder_heads=12, out_dim=768),
             False),
}


@pytest.mark.parametrize("name", sorted(REFUSAL))
def test_quant_int8_refused_exactly_where_jax_fails(name):
    """At full width: JAX's layer scan raises a TypeError (a bf16 carry in,
    an fp32 one out of the pre-norm int8 FFN) for XLS-R under exact
    numerics with the plain LayerNorm, mirror or not; the port refuses the
    same configs with a ValueError naming --fast_numerics, and builds the
    ones JAX runs (jax.eval_shape: nothing is compiled or allocated)."""
    fields, refused = REFUSAL[name]
    jcfg = JXLSRConfig(quant_int8=True, **fields)
    enc = JXLSREncoder(jcfg)
    x = jax.ShapeDtypeStruct((1, SR), jnp.float32)

    def shapes():
        v = jax.eval_shape(lambda x: enc.init(
            {"params": jax.random.PRNGKey(0)}, x), x)
        return jax.eval_shape(lambda v, x: enc.apply(v, x), v, x)

    if refused:
        with pytest.raises(TypeError, match="carry"):
            shapes()
        with pytest.raises(ValueError, match="--fast_numerics"):
            XLSRConfig(quant_int8=True, **fields)
    else:
        assert shapes().dtype == jnp.float32
        assert XLSRConfig(quant_int8=True, **fields).quant_int8


@pytest.mark.parametrize("cli", ["oc_classifier", "oc_server"])
def test_clis_refuse_exact_xlsr_int8_before_any_weights(tmp_path, cli):
    """XLS-R with --quant_int8 and no --fast_numerics: the ValueError comes
    before the checkpoint is looked at (a missing one would exit)."""
    missing = str(tmp_path / "none.pt")
    argv = ["--pretrained-sslaasist", missing, "--quant_int8", "--device",
            "cpu"]
    main = {"oc_classifier": oc_classifier.main,
            "oc_server": oc_server.main}[cli]
    if cli == "oc_server":
        argv += ["--artifacts_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="--fast_numerics"):
        main(argv)


# ---------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 bonafide train rows (and a spoof row the scorer filters out), 4
    eval utterances, and two perturbed Flax models exported in the
    reference naming: an AModel (AASISTConfig(), tiny XLSR: what the CLIs
    build with --xlsr_tiny) and an SSLResNet34 (the fused ssl_resnet34
    file of modes 1c1 / 2c1)."""
    root = tmp_path_factory.mktemp("int8_cli")
    train_dir, eval_dir = root / "train", root / "eval"
    train_dir.mkdir()
    eval_dir.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        utt = f"LA_T_{i:04d}"
        t = np.arange(2400) / SR
        write_wav(str(train_dir / f"{utt}.wav"),
                  0.3 * np.sin(2 * np.pi * (250 + 30 * i) * t), SR)
        lines.append(f"LA_{i:04d} {utt} - - bonafide")
    lines.append("LA_9999 LA_T_9999 - A01 spoof")
    write_wav(str(train_dir / "LA_T_9999.wav"), 0.2 * rng.normal(size=2400),
              SR)
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    utts = []
    for i in range(4):
        utt = f"LA_E_{i:04d}"
        write_wav(str(eval_dir / f"{utt}.wav"),
                  0.2 * rng.normal(size=2600 + 900 * i), SR)
        utts.append(utt)
    (root / "eval.txt").write_text("\n".join(utts) + "\n")
    out = {}
    for kind, jmodel in (
            ("amodel", JAModel(JAASISTConfig(),
                               xlsr_cfg=JXLSRConfig.tiny())),
            ("ssl_resnet34", JSSLResNet34(xlsr_cfg=JXLSRConfig.tiny()))):
        variables = perturbed(fabricated(jmodel, _wave()), seed=2)
        sd = state_dict_from_flax(variables, XLSRConfig.tiny())
        torch.save(sd, root / f"{kind}.pt")
        out[kind] = variables
    return root, out


def _cli_args(root, mode, score_file, *extra):
    weights = ("--pretrained-ssl" if mode in ("1c1", "2c1")
               else "--pretrained-sslaasist")
    kind = "ssl_resnet34" if mode in ("1c1", "2c1") else "amodel"
    return [weights, str(root / f"{kind}.pt"),
            "--protocol_file", str(root / "train.txt"),
            "--dataset_dir", str(root / "train"),
            "--eval_protocol_file", str(root / "eval.txt"),
            "--eval_dataset_dir", str(root / "eval"),
            "--mode", mode, "--score_file", str(score_file),
            "--batch_size", "2", "--bucket_step", "3200", "--xlsr_tiny",
            "--device", "cpu", "--quant_int8", *extra]


def _jax_int8(variables, kind, fast):
    """What the JAX CLIs run for --quant_int8: the restored fp32 tree
    through `quantize_params_int8`, the model rebuilt with quant_int8."""
    xcfg = dataclasses.replace(JXLSRConfig.tiny(), quant_int8=True,
                               **(FAST if fast else {}))
    model = (JAModel(JAASISTConfig(), xlsr_cfg=xcfg) if kind == "amodel"
             else JSSLResNet34(xlsr_cfg=xcfg))
    return model, dict(variables,
                       params=jint8.quantize_params_int8(variables["params"]))


@pytest.mark.parametrize("mode, fast", [
    ("1c2", False), ("1c2", True), ("2c2", False), ("1c1", False),
    ("1c1", True), ("2c1", False)])
def test_oc_classifier_int8_matches_jax(tree, tmp_path, monkeypatch, mode,
                                        fast):
    root, variables = tree
    kind = "ssl_resnet34" if mode in ("1c1", "2c1") else "amodel"
    monkeypatch.chdir(tmp_path)  # the 1c artefacts land here
    int8.CALLS = 0
    oc_classifier.main(_cli_args(root, mode, tmp_path / "scores.txt",
                                 *(["--fast_numerics"] if fast else [])))
    assert int8.CALLS > 0
    model, jvars = _jax_int8(variables[kind], kind, fast)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    scorer = JOneClassScorer(JBucketedEmbedder(
        embed_fn_factory=lambda blen: make_score_fn_v(model),
        bucket_step=3200, batch_size=2, variables=jvars),
        cache_dir=str(jdir))
    eval_ds = JASVDataset(str(root / "eval.txt"), str(root / "eval"),
                          eval=True)
    if mode in ("2c2", "2c1"):
        scorer.score_eval_set_2c(eval_ds, score_file=str(jdir / "s.txt"))
        got = np.loadtxt(tmp_path / "scores.txt")
        want = np.loadtxt(jdir / "s.txt")
        assert got.shape == (4,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=SCORE_RTOL,
                                   atol=SCORE_RTOL * np.abs(want).max())
        return
    jref, jthr = scorer.create_reference_embedding(
        JASVDataset(str(root / "train.txt"), str(root / "train")))
    scorer.score_eval_set_1c(eval_ds, jref, jthr,
                             score_file=str(jdir / "s.txt"))
    ref = np.load(tmp_path / "reference_embedding.npy")
    assert ref.shape == jref.shape
    assert _rel(ref, jref) <= REF_REL, _rel(ref, jref)
    atol = SCORE_RTOL * np.linalg.norm(jref)
    assert float(np.load(tmp_path / "threshold.npy")) == pytest.approx(
        jthr, rel=SCORE_RTOL, abs=atol)
    got = read_comma_scores(str(tmp_path / "scores.txt"))
    want = read_comma_scores(str(jdir / "s.txt"))
    assert len(got) == 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=atol)


@pytest.mark.parametrize("fast", [False, True])
def test_oc_server_int8_scores_as_jax(tree, tmp_path, fast):
    root, variables = tree
    reference = np.random.default_rng(4).normal(size=160).astype(np.float32)
    np.save(tmp_path / "reference_embedding.npy", reference)
    np.save(tmp_path / "threshold.npy", np.float32(12.0))
    started = threading.Event()
    started.stop = threading.Event()
    t = threading.Thread(target=oc_server.main, args=([
        "--pretrained-sslaasist", str(root / "amodel.pt"), "--artifacts_dir",
        str(tmp_path), "--host", "127.0.0.1", "--port", "0", "--xlsr_tiny",
        "--quant_int8", "--batch_size", "2", "--buckets", str(CUT),
        "--device", "cpu", "--no_warmup",
        *(["--fast_numerics"] if fast else [])], started), daemon=True)
    t.start()
    assert started.wait(timeout=120), "server failed to start"
    waves = list(_wave(seed=6, n=2900))
    try:
        int8.CALLS = 0
        got, _ = started.service.score(waves)
        calls = int8.CALLS
    finally:
        started.stop.set()
        t.join(timeout=30)
    assert calls == 6 * JXLSRConfig.tiny().encoder_layers  # one batch
    model, jvars = _jax_int8(variables["amodel"], "amodel", fast)
    jsvc = JScoringService(jmake_score_fn(model, jvars["params"],
                                          jvars["batch_stats"]),
                           reference, threshold=12.0, buckets=(CUT,),
                           batch=2)
    want, _ = jsvc.score(waves)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL)
