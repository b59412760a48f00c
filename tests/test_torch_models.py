"""The port's other models and their pieces (`occm_tpu_torch.models`
SEResNet, LCNN, AngleLinear, the CNNs, SSLResNet34, SSLLCNN, TotalCNNNet,
OCCM; `ops.pool`, `ops.mfm`; `losses.angle_loss`; the bridge and
`detect_model_kind`) against the JAX package, in eval mode.

The Flax variables are drawn on the host at Flax's init scales (shapes
from jax.eval_shape: no init is compiled), then every parameter and
BatchNorm statistic is perturbed (running means off zero, variances off
one) as tests/test_torch_aasist.py perturbs them, so a missing or
misplaced BN shows. Models: atol 3e-5 / rtol 1e-4
(tests/test_full_model_parity.py's tolerance) at unit output scale: an
output whose largest |value| s exceeds 1 is compared as output / s. The
random SE-ResNets grow their outputs to |value| ~ 70, and an element near
zero among them carries fp32 rounding of that scale (the port's SE-ResNet
alone is 1.7e-4 of such an element off its own fp64 forward, the JAX
side 2.2e-4). AngleLinear: atol 2e-5 on
cos, 2e-4 on psi (tests/test_lcnn_parity.py). Pools, mfm and the angle
loss: rtol 1e-6 (fp32, the same sums; the JAX adaptive pool's integral
image adds atol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.losses import AngleLossState as JAngleLossState
from occm_tpu.losses import angle_loss as j_angle_loss
from occm_tpu.models import OCCM as JOCCM
from occm_tpu.models import SSLLCNN as JSSLLCNN
from occm_tpu.models import SSLResNet34 as JSSLResNet34
from occm_tpu.models import TotalCNNNet as JTotalCNNNet
from occm_tpu.models import cnn as jcnn
from occm_tpu.models import convert_backend as jconv
from occm_tpu.models.lcnn import LCNN as JLCNN
from occm_tpu.models.lcnn import AngleLinear as JAngleLinear
from occm_tpu.models.senet import SEResNet as JSEResNet
from occm_tpu.ops import mfm as jmfm
from occm_tpu.ops import pool as jpool
from occm_tpu_torch import models, ops
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.losses import AngleLossState, angle_loss
from occm_tpu_torch.models import detect_model_kind, state_dict_from_flax
from occm_tpu_torch.models.convert import load_reference_state_dict

CUT = 3200


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch ops run on one thread: the models are tiny, and
    the suite's workers share the host's cores (oversubscribed, torch's
    worker threads spin)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
ATOL, RTOL = 3e-5, 1e-4
KEY = jax.random.PRNGKey(0)


def perturbed(variables, seed=0):
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def fabricated(model, x, seed=0, **kw):
    """Variables of `model` for input x, drawn on the host at Flax's init
    scales (kernels normal(1 / sqrt(fan_in)), the A-softmax weight
    uniform(-1, 1), norm scales 1, the rest 0; BatchNorm statistics 0 and
    1): the shapes come from jax.eval_shape, so nothing is compiled."""
    shapes = jax.eval_shape(lambda x: model.init(
        {"params": KEY, "dropout": KEY}, x, **kw), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name == "weight":
            return rng.uniform(-1.0, 1.0, s.shape).astype(np.float32)
        return np.full(s.shape, 1.0 if name in ("scale", "var") else 0.0,
                       np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_init(model, x, **kw):
    return perturbed(fabricated(model, x, **kw))


def flax_apply(model, variables, x, **kw):
    """model.apply, jitted (one compile instead of op-by-op dispatch)."""
    return jax.jit(lambda v, x: model.apply(v, x, **kw))(variables,
                                                          jnp.asarray(x))


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, atol, rtol)
        return
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy() / scale, want / scale,
                               atol=atol, rtol=rtol)


def maps(seed, c=1, h=40, w=64, b=3):
    return np.random.default_rng(seed).normal(size=(b, c, h, w)).astype(
        np.float32)


def wave(seed=1, b=2):
    return (np.random.default_rng(seed).normal(size=(b, CUT)) * 0.1).astype(
        np.float32)


# ------------------------------------------------------------- ops

@pytest.mark.parametrize("hw, out", [((40, 64), (1, 64)), ((10, 4), (1, 256)),
                                     ((7, 9), (3, 5)), ((5, 16), (9, 40))])
def test_adaptive_avg_pool_matches_jax(hw, out):
    """torch's windows for any pair of sizes, an output larger than the
    input included (the tiny XLSR's width 16 is 4 after CNNNet's two
    pools and pooled up to 256)."""
    x = maps(0, c=3, h=hw[0], w=hw[1])
    want = np.transpose(np.asarray(jpool.adaptive_avg_pool2d(nhwc(x), out)),
                        (0, 3, 1, 2))
    got = ops.adaptive_avg_pool2d(torch.from_numpy(x), out)
    # the JAX side differences two prefix sums of an integral image: a
    # rounding of ~2^-24 of a running sum of up to ~10 (unit normals)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_global_avg_max_and_avg_pools_match_jax():
    x = maps(1, c=4, h=13, w=11)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(ops.global_avg_pool2d(t).numpy(),
                               np.asarray(jpool.global_avg_pool2d(nhwc(x))),
                               rtol=1e-6, atol=1e-7)
    for fn, jfn, kw in ((ops.max_pool2d, jpool.max_pool2d,
                         dict(kernel=3, stride=2, padding=1)),
                        (ops.max_pool2d, jpool.max_pool2d, dict(kernel=2)),
                        (ops.avg_pool2d, jpool.avg_pool2d,
                         dict(kernel=3, stride=2))):
        want = np.transpose(np.asarray(jfn(nhwc(x), **kw)), (0, 3, 1, 2))
        np.testing.assert_allclose(fn(t, **kw).numpy(), want, rtol=1e-6,
                                   atol=1e-7)


def test_mfm_max_splits_channels_and_features():
    x = maps(2, c=6, h=5, w=7)
    want = np.transpose(np.asarray(jmfm.mfm_max(nhwc(x), 3)), (0, 3, 1, 2))
    np.testing.assert_array_equal(
        ops.mfm_max(torch.from_numpy(x), 3, dim=1).numpy(), want)
    d = x.reshape(3, -1)[:, :10]
    np.testing.assert_array_equal(ops.mfm_max(torch.from_numpy(d), 5).numpy(),
                                  np.asarray(jmfm.mfm_max(jnp.asarray(d), 5)))


# ------------------------------------------------------------- backends

@pytest.mark.parametrize("layers", [(3, 4, 6, 3), (1, 2, 3, 1)],
                         ids=["se_resnet34", "se_resnet12"])
def test_seresnet_matches_flax(layers):
    x = maps(3)
    jmodel = JSEResNet(layers=layers)
    variables = flax_init(jmodel, nhwc(x))
    want = flax_apply(jmodel, variables, nhwc(x), train=False)
    model = (models.se_resnet34() if layers == (3, 4, 6, 3)
             else models.se_resnet12())
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    got = model.eval()(torch.from_numpy(x))
    assert got[0].shape == (3, 128) and got[1].shape == (3, 2)
    assert_close(got, want)


@pytest.fixture(scope="module")
def lcnn_variables():
    """Flax LCNN variables with the A-softmax head, and with the Linear
    head (one init each)."""
    x = nhwc(maps(4))
    return {asm: flax_init(JLCNN(asoftmax=asm), x)
            for asm in (True, False)}


@pytest.mark.parametrize("asoftmax, phiflag, eval_mode", [
    (False, True, False), (True, True, False), (True, False, False),
    (True, True, True)], ids=["linear", "asoftmax", "asoftmax-nophi",
                              "asoftmax-eval"])
def test_lcnn_matches_flax(lcnn_variables, asoftmax, phiflag, eval_mode):
    x = maps(4)
    variables = lcnn_variables[asoftmax]
    want = flax_apply(JLCNN(asoftmax=asoftmax, phiflag=phiflag), variables,
                      nhwc(x), train=False, eval_mode=eval_mode)
    model = models.LCNN(asoftmax=asoftmax, phiflag=phiflag)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    got = model.eval()(torch.from_numpy(x), eval_mode=eval_mode)
    if asoftmax and not eval_mode:
        assert_close(got[0], want[0])
        assert_close(got[1], want[1], atol=2e-4)
    else:
        assert got.shape == (3, 2)
        assert_close(got, want)


@pytest.mark.parametrize("phiflag", [True, False])
def test_angle_linear_matches_flax(phiflag):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    layer = JAngleLinear(out_features=2, phiflag=phiflag)
    variables = layer.init({"params": KEY}, jnp.asarray(x))
    w = np.array(variables["params"]["weight"])
    port = models.AngleLinear(8, 2, phiflag=phiflag)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
    cos_t, psi_t = port(torch.from_numpy(x))
    jcos, jpsi = layer.apply(variables, jnp.asarray(x))
    assert_close(cos_t, jcos, atol=2e-5, rtol=0)
    assert_close(psi_t, jpsi, atol=2e-4, rtol=0)
    assert_close(port(torch.from_numpy(x), eval_mode=True),
                 layer.apply(variables, jnp.asarray(x), eval_mode=True),
                 atol=2e-5, rtol=0)
    # theta comes from a detached cos: psi's gradient is that of the
    # polynomial in cos alone, as in JAX
    g = torch.autograd.grad(psi_t.sum(), port.weight)[0]
    jg = jax.grad(lambda v: layer.apply(v, jnp.asarray(x))[1].sum())(
        variables)["params"]["weight"]
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("name, port_cls, channels", [
    ("CNNNet", models.CNNNet, 1), ("CNNNetBasic", models.CNNNetBasic, 1),
    ("CNNNetComplex", models.CNNNetComplex, 2),
    ("CNNNetWithAttention", models.CNNNetWithAttention, 1)])
def test_cnns_match_flax(name, port_cls, channels):
    x = maps(6, c=channels, h=24, w=16)
    jmodel = getattr(jcnn, name)()
    variables = flax_init(jmodel, nhwc(x))
    want = flax_apply(jmodel, variables, nhwc(x), train=False)
    model = port_cls()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    got = model.eval()(torch.from_numpy(x))
    assert got.shape == (3, 2)
    assert_close(got, want)


# ------------------------------------------------------------- fused models

FUSED = {"ssl_resnet34": (JSSLResNet34, models.SSLResNet34, {}),
         "ssl_lcnn": (JSSLLCNN, models.SSLLCNN, {}),
         "ssl_lcnn_asoftmax": (JSSLLCNN, models.SSLLCNN, {"asoftmax": True}),
         "cnn": (JTotalCNNNet, models.TotalCNNNet, {}),
         "occm": (JOCCM, models.OCCM, {})}


@pytest.fixture(scope="module")
def fused_variables():
    """Perturbed Flax variables of each fused model at the tiny XLSR."""
    cache = {}

    def get(name):
        if name not in cache:
            jcls, _, kw = FUSED[name]
            cache[name] = flax_init(jcls(xlsr_cfg=JXLSRConfig.tiny(), **kw),
                                    jnp.zeros((2, CUT)))
        return cache[name]

    return get


def port_model(name, variables):
    _, cls, kw = FUSED[name]
    model = cls(xlsr_cfg=XLSRConfig.tiny(), **kw)
    model.load_state_dict(state_dict_from_flax(variables, XLSRConfig.tiny()),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("name", ["ssl_resnet34", "ssl_lcnn", "cnn", "occm"])
def test_fused_models_match_flax(fused_variables, name):
    variables = fused_variables(name)
    jcls, _, kw = FUSED[name]
    x = wave()
    want = flax_apply(jcls(xlsr_cfg=JXLSRConfig.tiny(), **kw), variables, x,
                      train=False)
    model = port_model(name, variables)
    assert model.xlsr_cfg == XLSRConfig.tiny()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert_close(got, want)


def test_ssl_lcnn_asoftmax_eval_mode_matches_flax(fused_variables):
    variables = fused_variables("ssl_lcnn_asoftmax")
    x = wave(2)
    jmodel = JSSLLCNN(xlsr_cfg=JXLSRConfig.tiny(), asoftmax=True)
    model = port_model("ssl_lcnn_asoftmax", variables)
    with torch.no_grad():
        assert_close(model(torch.from_numpy(x), eval_mode=True),
                     flax_apply(jmodel, variables, x, train=False,
                                eval_mode=True))
        cos, psi = model(torch.from_numpy(x))
    jcos, jpsi = flax_apply(jmodel, variables, x, train=False)
    assert_close(cos, jcos)
    assert_close(psi, jpsi, atol=2e-4)


# ------------------------------------------------------------- angle loss

@pytest.mark.parametrize("it", [0, 1, 7, 300, 100_000])
@pytest.mark.parametrize("weighted", [False, True])
def test_angle_loss_matches_jax(it, weighted):
    rng = np.random.default_rng(it)
    cos = rng.uniform(-3, 3, size=(12, 2)).astype(np.float32)
    psi = rng.uniform(-6, 3, size=(12, 2)).astype(np.float32)
    target = np.array([0] * 6 + [1] * 6, np.int32)
    w = np.array([1] * 8 + [0] * 4, np.float32) if weighted else None
    want, jstate = j_angle_loss(
        (jnp.asarray(cos), jnp.asarray(psi)), jnp.asarray(target),
        JAngleLossState(it=jnp.asarray(it, jnp.int32)),
        weights=None if w is None else jnp.asarray(w))
    got, state = angle_loss(
        (torch.from_numpy(cos), torch.from_numpy(psi)),
        torch.from_numpy(target),
        AngleLossState(it=torch.tensor(it, dtype=torch.int64)),
        weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert int(state.it) == int(jstate.it) == it + 1
    # gradients at the same tolerance (pt is detached on both sides)
    c, p = torch.from_numpy(cos).requires_grad_(), torch.from_numpy(psi)
    p.requires_grad_()
    angle_loss((c, p), torch.from_numpy(target),
               AngleLossState(it=torch.tensor(it)),
               weights=None if w is None else torch.from_numpy(w)
               )[0].backward()
    jg = jax.grad(lambda a, b: j_angle_loss(
        (a, b), jnp.asarray(target),
        JAngleLossState(it=jnp.asarray(it, jnp.int32)),
        weights=None if w is None else jnp.asarray(w))[0], argnums=(0, 1))(
        jnp.asarray(cos), jnp.asarray(psi))
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg[0]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[1]), rtol=1e-5,
                               atol=1e-7)


def test_angle_loss_state_create():
    assert int(AngleLossState.create().it) == 0


# ------------------------------------------------------------- the bridge

def _save(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
                for k, v in sd.items()}, path)
    return str(path)


def test_reference_senet_and_lcnn_files_load_strictly(lcnn_variables,
                                                      tmp_path):
    """senet34_vocoded / LCNN `.pt` files that the JAX exporters write
    load strictly into the port and give the JAX outputs; the bridge
    agrees with the exporters key by key."""
    x = maps(7)
    jsenet = JSEResNet()
    variables = flax_init(jsenet, nhwc(x))
    sd = jconv.export_senet_state_dict(variables)
    bridged = state_dict_from_flax(variables)
    assert set(bridged) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(bridged[k].numpy(), np.asarray(v), k)
    senet = models.se_resnet34()
    state = load_reference_state_dict(_save(sd, tmp_path / "senet.pt"))
    assert detect_model_kind(state) == jconv.detect_model_kind(sd) == "senet"
    senet.load_state_dict(state, strict=True)
    assert_close(senet.eval()(torch.from_numpy(x)),
                 flax_apply(jsenet, variables, nhwc(x), train=False))

    for asm in (True, False):
        v = lcnn_variables[asm]
        sd = jconv.export_lcnn_state_dict(v)
        assert set(state_dict_from_flax(v)) == set(sd)
        lcnn = models.LCNN(asoftmax=asm)
        state = load_reference_state_dict(_save(sd, tmp_path / "lcnn.pt"))
        assert detect_model_kind(state) == "lcnn"
        lcnn.load_state_dict(state, strict=True)
        want = flax_apply(JLCNN(asoftmax=asm), v, nhwc(x), train=False)
        assert_close(lcnn.eval()(torch.from_numpy(x)), want,
                     atol=2e-4 if asm else ATOL)


def ssl_resnet34_reference_sd(variables):
    """`export_model_file`'s ssl_resnet34 layout of a Flax SSLResNet34."""
    sd = {f"frontend.model.{k}": v for k, v in jconv.export_xlsr_state_dict(
        variables["params"]["frontend"], JXLSRConfig.tiny()).items()}
    sd.update({f"resnet34.{k}": v for k, v in jconv.export_senet_state_dict(
        {"params": variables["params"]["resnet34"],
         "batch_stats": variables["batch_stats"]["resnet34"]}).items()})
    return sd


def test_reference_ssl_resnet34_files_load_strictly(fused_variables,
                                                    tmp_path):
    """The fused ssl_resnet34 file, and the separate ssl_vocoded
    (model.*) / senet34_vocoded pair split off it, load strictly into
    SSLResNet34 and its frontend / resnet34, and give the JAX outputs."""
    variables = fused_variables("ssl_resnet34")
    sd = ssl_resnet34_reference_sd(variables)
    fused = load_reference_state_dict(_save(sd, tmp_path / "fused.pt"))
    assert detect_model_kind(fused) == jconv.detect_model_kind(sd) \
        == "ssl_resnet34"
    x = wave(3)
    want = flax_apply(JSSLResNet34(xlsr_cfg=JXLSRConfig.tiny()), variables,
                      x, train=False)
    model = models.SSLResNet34(XLSRConfig.tiny())
    model.load_state_dict(fused, strict=True)
    with torch.no_grad():
        assert_close(model.eval()(torch.from_numpy(x)), want)

    ssl = {k[len("frontend."):]: v for k, v in sd.items()
           if k.startswith("frontend.")}
    senet = {k[len("resnet34."):]: v for k, v in sd.items()
             if k.startswith("resnet34.")}
    ssl_state = load_reference_state_dict(_save(ssl, tmp_path / "ssl.pt"))
    senet_state = load_reference_state_dict(
        _save(senet, tmp_path / "senet.pt"))
    assert detect_model_kind(ssl_state) == jconv.detect_model_kind(ssl) \
        == "ssl"
    assert detect_model_kind(senet_state) == "senet"
    pair = models.SSLResNet34(XLSRConfig.tiny())
    pair.frontend.load_state_dict(ssl_state, strict=True)
    pair.resnet34.load_state_dict(senet_state, strict=True)
    with torch.no_grad():
        assert_close(pair.eval()(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name", ["ssl_lcnn", "cnn", "occm"])
def test_fused_state_dicts_round_trip(fused_variables, name):
    """The port's own state dict of each fused model loads back strictly,
    the never-run LCNN group BatchNorms included, and every name the
    bridge emits is a name of the module."""
    variables = fused_variables(name)
    model = port_model(name, variables)
    bridged = state_dict_from_flax(variables, XLSRConfig.tiny())
    assert set(bridged) == set(model.state_dict())
    again = FUSED[name][1](xlsr_cfg=XLSRConfig.tiny(), **FUSED[name][2])
    again.load_state_dict(model.state_dict(), strict=True)
    if name != "cnn":
        dead = [k for k in bridged if ".0.bn." in k]
        assert dead and all(k.split(".")[0] in ("lcnn", "lcnn_branch")
                            for k in dead)


def test_detect_model_kind_matches_jax():
    cases = [{"ssl_model.model.layer_norm.weight": 0, "pos_S": 0},
             {"module.layer4.0.conv1.weight": 0, "embedding.weight": 0},
             {"layer1.0.filter.weight": 0, "fc3.weight": 0},
             {"model.layer_norm.weight": 0},
             {"feature_extractor.conv_layers.0.0.weight": 0}]
    for sd in cases:
        assert detect_model_kind(sd) == jconv.detect_model_kind(sd)
    with pytest.raises(ValueError, match="unrecognised"):
        detect_model_kind({"something.else": 0})
