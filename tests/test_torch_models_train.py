"""Training and scoring the port's other models (`occm_tpu_torch.train`
with each output kind, `.cli.oc_classifier` modes 1c1 / 2c1) against the
JAX package, at the tiny XLSR (XLSRConfig.tiny(), cut 3200).

- Two train steps of each output kind against
  `occm_tpu.train.loop.make_train_step(cfg, output_kind=...)`: "dual"
  (SSLResNet34), "logits" (TotalCNNNet), "angle" (SSLLCNN with the
  A-softmax head: the second step anneals lambda from step count 1) and
  "occm" (OCCM), from the same weights (drawn on the host at Flax's init
  scales), Adam, RawBoost off (`RawBoostConfig(algo=0)`) on both sides.
  Step 2 runs from the JAX state after step 1 (weights, BatchNorm
  statistics and Adam moments through the bridge). The backends'
  dropout (LCNN 0.75, CNN 0.5) draws masks that two random
  number generators cannot share, so it is off on both sides: the Flax
  `nn.Dropout` is the identity for the JAX steps, and the port's rates are
  set to 0. Flax's BatchNorm computes the batch variance as E[x^2] -
  E[x]^2 by default (`use_fast_variance`), which cancels on the
  SE-ResNet's and LCNN's maps: its gradients sit 2-6 % off an fp64
  forward, against 1e-5 with the two-pass E[(x - E[x])^2] that torch
  computes. The JAX steps run the two-pass form (the same function, other
  roundings). Each step, from JAX's state before it, is held to: the loss
  to 1e-5 relative; every parameter to optax's Adam of the port's own
  gradient within 1e-6, and to JAX's within the 2 * lr + 1e-6 one step
  can move it; BatchNorm statistics to 1e-5; the gradient to JAX's (read
  back from its first moment, mu = 0.9 mu0 + 0.1 g) within 5e-2 of its
  norm, over the entries that are not float noise. That last tolerance is
  set by the backends' kinks, not by rounding: a ReLU, max pool or MFM
  max whose input lies within rounding of its switch routes its gradient
  elsewhere, and BatchNorm's backward spreads each switch over its
  channel. Scaling the port's input by 1 +- 1e-5 moves its own gradient
  by 1e-3 - 2.1e-2 of its norm (measured for these batches and weights);
  the port and JAX, whose forwards differ by ~1e-6 relative, differ by
  3e-6 - 1.7e-2. So tests/test_torch_train.py's count of parameters past
  1e-6 of JAX's (its AASIST, SELU-activated, has few kinks) does not
  apply here: up to 12 % of them move past it at step 2, where Adam's
  update is a smooth function of the gradient.
- The device step count (`state.step_t`) moves with every update and is
  saved and restored by checkpoints.
- `oc_classifier --mode 1c1` / `2c1` on the CPU score an SSLResNet34 from
  the fused ssl_resnet34 file and from the separate ssl_vocoded /
  senet34_vocoded pair split off it: equal score files, and the fused
  1c1 run against the JAX scorer on the same weights (1e-4 relative, as
  tests/test_torch_classifier_cli.py).
"""

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.classify import BucketedEmbedder as JBucketedEmbedder
from occm_tpu.classify import OneClassScorer as JOneClassScorer
from occm_tpu.config import RawBoostConfig as JRawBoostConfig
from occm_tpu.config import TrainConfig as JTrainConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.data import ASVDataset as JASVDataset
from occm_tpu.io.scorefiles import read_comma_scores
from occm_tpu.models import OCCM as JOCCM
from occm_tpu.models import SSLLCNN as JSSLLCNN
from occm_tpu.models import SSLResNet34 as JSSLResNet34
from occm_tpu.models import TotalCNNNet as JTotalCNNNet
from occm_tpu.models import convert_backend as jconv
from occm_tpu.serve import make_score_fn_v
from occm_tpu.train.loop import make_optimizer as j_make_optimizer
from occm_tpu.train.loop import make_train_step
from occm_tpu.train.state import TrainState as JTrainState
from occm_tpu_torch import models
from occm_tpu_torch.cli import oc_classifier
from occm_tpu_torch.config import RawBoostConfig, TrainConfig, XLSRConfig
from occm_tpu_torch.io.wav import write_wav
from occm_tpu_torch.models import state_dict_from_flax
from occm_tpu_torch.models.convert import optimizer_state_from_flax
from occm_tpu_torch.train import create_train_state, train_step
from occm_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from occm_tpu_torch.train.loop import _loss
from test_torch_models import fabricated, perturbed

SR = 16000
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
LR = 1e-3
RTOL = 1e-4
# the step gradient against JAX's, relative to its norm (module docstring)
GRAD_RTOL = 5e-2

# output kind -> (JAX model, port model, constructor keywords)
KINDS = {"dual": (JSSLResNet34, models.SSLResNet34, {}),
         "logits": (JTotalCNNNet, models.TotalCNNNet, {}),
         "angle": (JSSLLCNN, models.SSLLCNN, {"asoftmax": True}),
         "occm": (JOCCM, models.OCCM, {})}


def _train_cfgs():
    common = dict(optimizer="adam", lr=LR, cut=CUT, compactness_weight=0.1,
                  descriptiveness_weight=0.9)
    return (JTrainConfig(**common, rawboost=JRawBoostConfig(algo=0)),
            TrainConfig(**common, rawboost=RawBoostConfig(algo=0)))


def _batch():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(12, CUT)) * 0.1).astype(np.float32)
    return x, np.array([0] * 6 + [1] * 6, np.int32)


@pytest.fixture(scope="module")
def jax_steps():
    """Per output kind, two JAX train steps on one seeded batch, with the
    Flax dropout the identity: the initial, step-1 and step-2 states and
    the two losses."""
    jcfg, _ = _train_cfgs()
    x, labels = _batch()
    snap = lambda s: jax.tree_util.tree_map(np.asarray, s)  # noqa: E731
    out = {}
    two_pass = flax.linen.normalization._compute_stats
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, inputs, *a, **k: inputs)
        mp.setattr(flax.linen.normalization, "_compute_stats",
                   lambda *a, **k: two_pass(
                       *a, **{**k, "use_fast_variance": False}))
        for kind, (jcls, _, kw) in KINDS.items():
            model = jcls(xlsr_cfg=JXLSRConfig.tiny(), **kw)
            tx, _ = j_make_optimizer(jcfg)
            variables = jax.tree_util.tree_map(jnp.asarray, fabricated(
                model, np.zeros((12, CUT), np.float32)))
            state0 = JTrainState(
                step=jnp.zeros((), jnp.int32), params=variables["params"],
                batch_stats=variables["batch_stats"],
                opt_state=tx.init(variables["params"]), tx=tx,
                apply_fn=model.apply)
            step = make_train_step(jcfg, output_kind=kind)
            batch = (jnp.asarray(x), jnp.asarray(labels))
            s0 = snap(state0)  # the step donates its input state
            state1, m1 = step(state0, batch, jax.random.PRNGKey(1))
            s1 = snap(state1)
            state2, m2 = step(state1, batch, jax.random.PRNGKey(2))
            out[kind] = dict(s0=s0, s1=s1, s2=snap(state2),
                             loss1=float(m1["loss"]),
                             loss2=float(m2["loss"]))
    return out


def _variables(jstate):
    return {"params": jstate.params, "batch_stats": jstate.batch_stats}


def _port_state(kind, jstate):
    _, cls, kw = KINDS[kind]
    model = cls(xlsr_cfg=XLSRConfig.tiny(), **kw)
    model.load_state_dict(state_dict_from_flax(_variables(jstate),
                                               XLSRConfig.tiny()),
                          strict=True)
    for m in model.modules():  # the backends' dropout off (module doc)
        if isinstance(m, models.lcnn.MFMDense):
            m.dp_out = 0.0
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    _, cfg = _train_cfgs()
    return create_train_state(model, cfg, kind), cfg


def _gradients(state, x, labels, cfg):
    """The step's gradient at the current weights, by parameter name, and
    the masks of its entries below 1e-6 of the largest (zero up to float
    noise); the BatchNorm statistics are left as they were."""
    model = state.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    loss, _ = _loss(state, x, labels, cfg, None)
    loss.backward()
    grads = {n: p.grad.double() for n, p in model.named_parameters()
             if p.grad is not None}
    top = max(float(g.abs().max()) for g in grads.values())
    model.zero_grad(set_to_none=True)
    model.load_state_dict(saved)
    return grads, {n: g.abs() < 1e-6 * top for n, g in grads.items()}


def _by_name(tree, jstate):
    """A parameter-shaped JAX tree by port parameter name (the positional
    conv's folded kernel as `...pos_conv.0.weight`)."""
    sd = state_dict_from_flax({"params": tree,
                               "batch_stats": jstate.batch_stats},
                              XLSRConfig.tiny())
    return {(k[:-2] if k.endswith("pos_conv.0.weight_v") else k):
            v.double() for k, v in sd.items()}


def _assert_step(model, before, grads, noise, ref_in, ref_out):
    """One port step (`model` after it, `before` its parameters before
    it, `grads` its gradient) against JAX's from the same state."""
    t = int(ref_out.step)
    mu0 = _by_name(ref_in.opt_state[0].mu, ref_in)
    nu0 = _by_name(ref_in.opt_state[0].nu, ref_in)
    mu1 = _by_name(ref_out.opt_state[0].mu, ref_out)
    want_p = _by_name(ref_out.params, ref_out)
    got = {n: p.detach().double() for n, p in model.named_parameters()}
    num = den = 0.0
    for name, g in grads.items():
        # JAX's gradient, read back from its first moment
        g_jax = (mu1[name] - 0.9 * mu0[name]) / 0.1
        keep = ~noise[name]
        num += float((g - g_jax)[keep].square().sum())
        den += float(g_jax[keep].square().sum())
        # the update is optax's Adam of the port's own gradient
        m = 0.9 * mu0[name] + 0.1 * g
        v = 0.999 * nu0[name] + 0.001 * g * g
        upd = (m / (1 - 0.9 ** t)) / (torch.sqrt(v / (1 - 0.999 ** t))
                                      + 1e-8)
        np.testing.assert_allclose(got[name].numpy(),
                                   (before[name] - LR * upd).numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert den > 0 and num <= GRAD_RTOL ** 2 * den, (num / den) ** 0.5
    for name, p in got.items():  # never-run BNs included: unchanged
        assert float((p - want_p[name]).abs().max()) <= 2 * LR + 1e-6, name
    want = state_dict_from_flax(_variables(ref_out), XLSRConfig.tiny())
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_steps_match_jax(jax_steps, kind):
    ref = jax_steps[kind]
    x, labels = (torch.from_numpy(a) for a in _batch())
    labels = labels.long()
    for n, (s_in, s_out) in enumerate(((ref["s0"], ref["s1"]),
                                       (ref["s1"], ref["s2"])), start=1):
        # each step from JAX's state before it: weights, BatchNorm
        # statistics, Adam's moments and count (for the angle loss,
        # lambda at count n - 1)
        state, cfg = _port_state(kind, s_in)
        state.load_optimizer_state(
            optimizer_state_from_flax(s_in.opt_state, XLSRConfig.tiny()))
        state.set_step(int(s_in.step))
        before = {k: p.detach().double().clone()
                  for k, p in state.model.named_parameters()}
        grads, noise = _gradients(state, x, labels, cfg)
        metrics = train_step(state, x, labels, cfg)
        assert float(metrics["loss"]) == pytest.approx(ref[f"loss{n}"],
                                                       rel=1e-5)
        if kind in ("logits", "angle"):
            assert float(metrics["closs"]) == 0.0
        assert state.step == int(state.step_t) == n
        _assert_step(state.model, before, grads, noise, s_in, s_out)


def test_angle_loss_anneals_from_the_device_step_count(jax_steps):
    """The angle kind reads lambda from `state.step_t`: from JAX's state
    after step 1, the forward's loss at count 1 is JAX's step-2 loss
    (1e-5), and at counts 0 and 2 it is off by more than 10 times that."""
    ref = jax_steps["angle"]
    x, labels = (torch.from_numpy(a) for a in _batch())
    for count in (0, 1, 2):
        state, cfg = _port_state("angle", ref["s1"])
        state.set_step(count)
        with torch.no_grad():
            loss = float(_loss(state, x, labels.long(), cfg, None)[0])
        off = abs(loss - ref["loss2"]) / abs(ref["loss2"])
        assert off <= 1e-5 if count == 1 else off > 1e-4, (count, off)


def test_checkpoint_saves_and_restores_the_device_step_count(jax_steps,
                                                             tmp_path):
    state, cfg = _port_state("angle", jax_steps["angle"]["s0"])
    x, labels = (torch.from_numpy(a) for a in _batch())
    for _ in range(2):
        train_step(state, x, labels.long(), cfg)
    save_checkpoint(state, str(tmp_path), "ssl_lcnn_asoftmax_vocoded", 0)
    fresh, _ = _port_state("angle", jax_steps["angle"]["s0"])
    assert int(fresh.step_t) == 0
    restore_checkpoint(fresh, str(tmp_path), "ssl_lcnn_asoftmax_vocoded", 0)
    assert fresh.step == int(fresh.step_t) == 2


def test_unknown_output_kind_raises():
    _, cfg = _train_cfgs()
    with pytest.raises(ValueError, match="output_kind"):
        create_train_state(torch.nn.Linear(2, 2), cfg, "emb")


# ------------------------------------------------------- scoring 1c1 / 2c1

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 bonafide train rows (and a spoof row the scorer filters out), 3
    eval utterances, and a perturbed Flax SSLResNet34 written by the JAX
    exporters as the fused ssl_resnet34 file and as the separate
    ssl_vocoded (model.*) / senet34_vocoded pair."""
    root = tmp_path_factory.mktemp("ssl_resnet34_cli")
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
    for i in range(3):
        utt = f"LA_E_{i:04d}"
        write_wav(str(eval_dir / f"{utt}.wav"),
                  0.2 * rng.normal(size=2600 + 900 * i), SR)
        utts.append(utt)
    (root / "eval.txt").write_text("\n".join(utts) + "\n")

    variables = perturbed(fabricated(JSSLResNet34(
        xlsr_cfg=JXLSRConfig.tiny()), np.zeros((2, CUT), np.float32)))
    ssl = {f"model.{k}": v for k, v in jconv.export_xlsr_state_dict(
        variables["params"]["frontend"], JXLSRConfig.tiny()).items()}
    senet = jconv.export_senet_state_dict(
        {"params": variables["params"]["resnet34"],
         "batch_stats": variables["batch_stats"]["resnet34"]})
    fused = {f"frontend.{k}": v for k, v in ssl.items()}
    fused.update({f"resnet34.{k}": v for k, v in senet.items()})
    for name, sd in (("ssl_resnet34_vocoded_0.pt", fused),
                     ("ssl_vocoded_0.pt", ssl),
                     ("senet34_vocoded_0.pt", senet)):
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   root / name)
    return root, variables


def _args(root, mode, score_file, *weights):
    return ["--protocol_file", str(root / "train.txt"),
            "--dataset_dir", str(root / "train"),
            "--eval_protocol_file", str(root / "eval.txt"),
            "--eval_dataset_dir", str(root / "eval"),
            "--mode", mode, "--score_file", str(score_file),
            "--batch_size", "2", "--bucket_step", "3200", "--xlsr_tiny",
            "--device", "cpu", *weights]


def _weights(root, how):
    if how == "fused":
        return ["--pretrained-ssl", str(root / "ssl_resnet34_vocoded_0.pt")]
    if how == "sslaasist":  # the fused file through the AModel flag
        return ["--pretrained-sslaasist",
                str(root / "ssl_resnet34_vocoded_0.pt")]
    return ["--pretrained-ssl", str(root / "ssl_vocoded_0.pt"),
            "--pretrained-senet", str(root / "senet34_vocoded_0.pt")]


@pytest.mark.parametrize("mode", ["1c1", "2c1"])
def test_separate_modes_score_equally_from_fused_file_and_pair(
        tree, tmp_path, monkeypatch, mode):
    root, _ = tree
    files = {}
    for how in ("fused", "pair", "sslaasist"):
        run = tmp_path / how
        run.mkdir()
        monkeypatch.chdir(run)  # the 1c artefacts land in the working dir
        oc_classifier.main(_args(root, mode, run / "scores.txt",
                                 *_weights(root, how)))
        files[how] = (run / "scores.txt").read_text()
        assert (run / "reference_embedding.npy").exists() == (mode == "1c1")
    assert len(files["fused"].splitlines()) == 3
    assert files["pair"] == files["fused"] == files["sslaasist"]


def test_one_class_mode_1c1_matches_jax_scorer(tree, tmp_path, monkeypatch):
    root, variables = tree
    monkeypatch.chdir(tmp_path)
    oc_classifier.main(_args(root, "1c1", tmp_path / "scores.txt",
                             *_weights(root, "fused")))
    ref = np.load(tmp_path / "reference_embedding.npy")
    thr = float(np.load(tmp_path / "threshold.npy"))

    jdir = tmp_path / "jax"
    jdir.mkdir()
    model = JSSLResNet34(xlsr_cfg=JXLSRConfig.tiny())
    scorer = JOneClassScorer(JBucketedEmbedder(
        embed_fn_factory=lambda blen: make_score_fn_v(model),
        bucket_step=3200, batch_size=2, variables=variables),
        cache_dir=str(jdir))
    jref, jthr = scorer.create_reference_embedding(
        JASVDataset(str(root / "train.txt"), str(root / "train")))
    scorer.score_eval_set_1c(
        JASVDataset(str(root / "eval.txt"), str(root / "eval"), eval=True),
        jref, jthr, score_file=str(jdir / "scores.txt"))
    assert ref.shape == (128,)
    np.testing.assert_allclose(ref, jref, rtol=RTOL,
                               atol=RTOL * np.abs(jref).max())
    atol = RTOL * np.linalg.norm(jref)
    assert thr == pytest.approx(jthr, rel=RTOL, abs=atol)
    got = read_comma_scores(str(tmp_path / "scores.txt"))
    want = read_comma_scores(str(jdir / "scores.txt"))
    assert len(got) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def test_separate_modes_fail_fast_and_name_a_wrong_file(tree, tmp_path):
    root, _ = tree
    with pytest.raises(SystemExit, match="does not exist"):
        oc_classifier.main(_args(root, "1c1", tmp_path / "s.txt",
                                 "--pretrained-ssl", str(tmp_path / "no.pt"),
                                 "--pretrained-senet",
                                 str(root / "senet34_vocoded_0.pt")))
    # an ssl_vocoded file alone is not a fused ssl_resnet34 file
    with pytest.raises(SystemExit, match="ssl checkpoint, not ssl_resnet34"):
        oc_classifier.main(_args(root, "2c1", tmp_path / "s.txt",
                                 "--pretrained-ssl",
                                 str(root / "ssl_vocoded_0.pt")))
    assert not (tmp_path / "s.txt").exists()
