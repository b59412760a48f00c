"""train(resume=True) and `oc_training --resume` continuing a run of the
JAX package from its orbax directories (`occm_tpu_torch.train.checkpoint`
`find_resume` / `restore_jax_checkpoint`), against the JAX package.

The JAX directories are written by the JAX package's own
`save_checkpoint` / `save_step_checkpoint`, on Flax variables fabricated
on the host (jax.eval_shape, `test_torch_models.fabricated`, perturbed)
and on Adam moments drawn from numpy, so nothing is initialised or
compiled for them. What is held:

- the state resume restores (stopped by a pipeline that raises on the
  first batch) is the bridge of the directory's arrays bit for bit, under
  each optimizer form (optax adam with a constant lr and under a cosine
  schedule, FusedAdam), for every model kind the bridge takes, and training
  goes on at the next epoch;
- a step directory: the consumed dispatches are skipped, the first batch
  trained is the JAX pipeline's next one, and the running sums carry into
  loss.txt;
- one port step after the resume against the JAX package's step from the
  same checkpoint (dropout and RawBoost off), at tests/test_torch_train.py's
  tolerances (loss rel 1e-5, the state by `_assert_state_matches`);
- the newest checkpoint wins across the two formats, a .pt on a tie;
- a wrong optimizer form, a missing moment, a schedule count that is not
  Adam's, another model's tree and a tree of weights only raise ValueError
  before any step;
- the JAX directories are byte for byte unchanged after the port saves
  epoch and step .pt files beside them, and the next resume takes the .pt;
- two resumes of one directory, and a .pt of the restored state, train to
  the same losses bit for bit (dropouts and RawBoost on);
- `oc_training --resume` on the CPU, in one process and over two Gloo
  ranks at tp=2.

The JAX directories' `chip_smoke.write_jax_checkpoint` counterpart (the
writer the card's phase 23 uses, which cannot import JAX) is held against
the JAX package's saver here too.
"""

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import RawBoostConfig as JRawBoostConfig
from occm_tpu.config import TrainConfig as JTrainConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.data import MetaBatchPipeline as JMetaBatchPipeline
from occm_tpu.data import PFDataset as JPFDataset
from occm_tpu.models import AModel as JAModel
from occm_tpu.ops.fused_adam import FusedAdamState
from occm_tpu.train import checkpoint as jckpt
from occm_tpu.train.loop import make_optimizer as j_make_optimizer
from occm_tpu.train.loop import make_train_step
from occm_tpu.train.state import TrainState as JTrainState
from occm_tpu_torch.cli import oc_training
from occm_tpu_torch.config import (
    AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
from occm_tpu_torch.models import AModel, state_dict_from_flax
from occm_tpu_torch.models.convert import optimizer_state_from_flax
from occm_tpu_torch.ops.fused_adam import FusedAdam
from occm_tpu_torch.train import checkpoint, create_train_state, loop, train
from occm_tpu_torch.train.checkpoint import (
    find_resume, resume_seed, save_checkpoint)
from occm_tpu_torch.train.orbax import restore_tree
from occm_tpu_torch.utils.logging import MetricsLogger

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.dirname(TESTS))

from test_torch_models import FUSED, fabricated, perturbed  # noqa: E402
from test_torch_train import (  # noqa: E402
    LR, _assert_state_matches, _noise_masks, write_fixture)

PREFIX = "aasist_vocoded"
CUT = 3200
STEP = 7     # the JAX run's step and Adam count
EPOCH = 2    # its epoch checkpoint
SEED = 5
FORMS = ("adam", "adam_schedule", "fused_adam")
#: the training configuration of each optimizer form (both packages'
#: TrainConfig field names)
OPTIMIZERS = {"adam": dict(optimizer="adam"),
              "adam_schedule": dict(optimizer="adam", lr_schedule="cosine",
                                    warmup_steps=2, decay_steps=20),
              "fused_adam": dict(optimizer="fused_adam")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the models are tiny and the suite's workers share
    the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs():
    """The tiny AModel of tests/test_torch_train.py's step (d 128, the
    dropouts off) on the plain attention and LayerNorm, for both
    packages."""
    jx = dataclasses.replace(JXLSRConfig.tiny(), encoder_embed_dim=128)
    px = dataclasses.replace(XLSRConfig.tiny(), encoder_embed_dim=128)
    ja = dataclasses.replace(JAASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    pa = dataclasses.replace(AASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    return jx, px, ja, pa


@pytest.fixture(scope="module")
def fused_variables():
    """Perturbed Flax variables of each fused model at the tiny XLSR."""
    cache = {}

    def get(name):
        if name not in cache:
            jcls, _, kw = FUSED[name]
            cache[name] = perturbed(fabricated(
                jcls(xlsr_cfg=JXLSRConfig.tiny(), **kw),
                np.zeros((2, CUT), np.float32)))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def variables():
    jx, _, ja, _ = _configs()
    return perturbed(fabricated(JAModel(ja, xlsr_cfg=jx),
                                np.zeros((2, CUT), np.float32)))


def jax_state(variables, form, step=STEP, sched_count=None, seed=0):
    """A JAX TrainState of `variables` at `step` under the optimizer of
    `form`, its moments drawn from numpy (mu ~ N(0, 1e-2), nu ~
    U(1e-4, 2e-4))."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    mu, nu = (jax.tree_util.tree_map(lambda p: jnp.asarray(draw(p.shape)),
                                     params)
              for draw in (lambda s: rng.normal(0, 1e-2, s).astype(
                  np.float32), lambda s: rng.uniform(1e-4, 2e-4, s).astype(
                      np.float32)))
    count = jnp.asarray(step, jnp.int32)
    tx, _ = j_make_optimizer(JTrainConfig(lr=LR, **OPTIMIZERS[form]))
    if form == "fused_adam":
        opt = FusedAdamState(count=count, mu=mu, nu=nu)
    else:
        init = tx.init(params)
        opt = (init[0]._replace(count=count, mu=mu, nu=nu), init[1])
        if form == "adam_schedule":
            opt = (opt[0], init[1]._replace(count=jnp.asarray(
                step if sched_count is None else sched_count, jnp.int32)))
    return JTrainState(step=jnp.asarray(step, jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=opt, tx=tx, apply_fn=None)


def train_cfg(directory, form="adam", **kw):
    return TrainConfig(**{**dict(
        lr=LR, cut=CUT, seed=SEED, num_epochs=EPOCH + 2,
        checkpoint_dir=str(directory), checkpoint_prefix=PREFIX,
        compactness_weight=0.1, descriptiveness_weight=0.9,
        loss_txt=str(directory / "loss.txt"),
        rawboost=RawBoostConfig(algo=0)), **OPTIMIZERS[form], **kw})


class Reached(Exception):
    """Raised by the pipeline: training got as far as its first batch."""


class Raising:
    """A pipeline that records the epochs asked for and raises on the
    first batch."""

    def __init__(self):
        self.epochs = []

    def epoch(self, epoch):
        self.epochs.append(epoch)
        raise Reached
        yield


class Batches:
    """The same batches every epoch."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        return iter(self.batches)


def resumed(model, pipeline, cfg, monkeypatch, **kw):
    """train(resume=True) on the CPU: (the TrainState it built, each
    step's loss, closs and dloss); a Reached from the pipeline ends it."""
    states, losses = [], []
    make = loop.create_train_state

    def capture(*a, **k):
        states.append(make(*a, **k))
        return states[-1]

    monkeypatch.setattr(loop, "create_train_state", capture)
    try:
        train(model, pipeline, cfg, device="cpu", resume=True,
              on_step=lambda s, m: losses.append(
                  {k: float(m[k]) for k in ("loss", "closs", "dloss")}),
              **kw)
    except Reached:
        pass
    return states[0], losses


def port_model(seed=0, pa=None, px=None):
    _, px0, _, pa0 = _configs()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return AModel(pa or pa0, px or px0)


def bridged(model, variables, xlsr_cfg):
    """`model` loaded with the bridge of `variables` as the resume loads
    it (the positional conv's kernel as the tree holds it)."""
    sd = state_dict_from_flax(variables, xlsr_cfg)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("pos_conv.0.weight"):
                p.copy_(sd[name + "_v"])
    return model


def assert_restored(state, want_model, jopt, xlsr_cfg, step=STEP):
    """The restored state is the bridge of the JAX state bit for bit."""
    got, want = state.model.state_dict(), want_model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    expect = optimizer_state_from_flax(jopt, xlsr_cfg)
    opt = state.optimizer_state()
    assert opt["count"] == expect["count"] == step
    for key in ("mu", "nu"):
        assert set(expect[key]) <= set(opt[key])
        for n, m in opt[key].items():
            if n in expect[key]:
                assert torch.equal(m, expect[key][n]), (key, n)
            else:  # a parameter the JAX tree has none of: never trained
                assert not m.any(), (key, n)
    assert state.step == step and int(state.step_t) == step
    assert torch.equal(state.generator.get_state(), torch.Generator(
    ).manual_seed(resume_seed(SEED, step)).get_state())


# ------------------------------------------------------ (i) the three forms

@pytest.mark.parametrize("form", FORMS)
def test_resume_restores_a_jax_epoch_directory(variables, tmp_path,
                                               monkeypatch, form):
    jstate = jax_state(variables, form)
    jckpt.save_checkpoint(jstate, str(tmp_path), PREFIX, EPOCH)
    pipe = Raising()
    state, _ = resumed(port_model(1), pipe, train_cfg(tmp_path, form),
                       monkeypatch)
    assert pipe.epochs == [EPOCH + 1]
    px = _configs()[1]
    assert_restored(state, bridged(port_model(2), variables, px),
                    jstate.opt_state, px)
    assert isinstance(state.optimizer, FusedAdam if form == "fused_adam"
                      else torch.optim.Adam)
    assert (state.schedule is not None) == (form == "adam_schedule")


# -------------------------------------------------- (ii) every model kind

@pytest.mark.parametrize("name", sorted(FUSED))
def test_resume_restores_every_model_kind(fused_variables, tmp_path,
                                          monkeypatch, name):
    _, cls, kw = FUSED[name]
    v = fused_variables(name)
    jstate = jax_state(v, "adam")
    jckpt.save_checkpoint(jstate, str(tmp_path), f"{name}_vocoded", EPOCH)
    cfg = dataclasses.replace(train_cfg(tmp_path),
                              checkpoint_prefix=f"{name}_vocoded")
    pipe = Raising()
    state, _ = resumed(cls(xlsr_cfg=XLSRConfig.tiny(), **kw), pipe, cfg,
                       monkeypatch,
                       output_kind=oc_training.OUTPUT_KIND_OF[name])
    assert pipe.epochs == [EPOCH + 1]
    assert_restored(state, bridged(cls(xlsr_cfg=XLSRConfig.tiny(), **kw), v,
                                   XLSRConfig.tiny()),
                    jstate.opt_state, XLSRConfig.tiny())


# -------------------------------------------------- (iii) a step directory

def test_resume_replays_a_jax_step_directory(variables, tmp_path,
                                             monkeypatch):
    """JAX's `_0/` and a newer `_step_2/` (epoch 1, 2 dispatches): the
    step directory wins, the first batch trained is the JAX pipeline's
    third of epoch 1, the running sums go on into loss.txt, and the
    events are JAX's."""
    protocol, train_dir, voc_dir = write_fixture(tmp_path)
    ckpt = tmp_path / "ckpt"
    jckpt.save_checkpoint(jax_state(variables, "adam", step=1),
                          str(ckpt), PREFIX, 0)
    progress = {"epoch": 1, "dispatches": 2, "opt_steps": 2,
                "running_loss": 30.0, "running_closs": 4.0,
                "running_dloss": 26.0}
    jstate = jax_state(variables, "adam")
    jckpt.save_step_checkpoint(jstate, str(ckpt), PREFIX, progress)
    want = [np.asarray(x) for x, _ in JMetaBatchPipeline(
        JPFDataset(protocol, train_dir, voc_dir, cut=CUT, seed=3),
        groups_per_step=1, seed=3, shard_index=0, shard_count=1).epoch(1)]
    first, step = [], loop.train_step

    def recording(state, x, *a, **k):
        first.append(x.clone())
        return step(state, x, *a, **k)

    monkeypatch.setattr(loop, "train_step", recording)
    pipeline = MetaBatchPipeline(
        PFDataset(protocol, train_dir, voc_dir, cut=CUT, seed=3), seed=3)
    cfg = train_cfg(ckpt, seed=3, num_epochs=2, log_every=1,
                    loss_txt=str(tmp_path / "loss.txt"))
    state, metrics = resumed(
        port_model(), pipeline, cfg, monkeypatch,
        logger=MetricsLogger(cfg.loss_txt, str(tmp_path / "m.jsonl")))
    assert len(want) == 6 and len(first) == len(metrics) == 4
    assert first[0].numpy().tobytes() == want[2].tobytes()
    assert state.step == STEP + 4
    lines = (tmp_path / "loss.txt").read_text().splitlines()
    m = metrics[0]
    assert lines[0] == (
        f"epoch = 2, i = 3, loss = {(30.0 + m['loss']) / 3:.3f}, "
        f"closs = {(4.0 + m['closs']) / 3:.3f}, "
        f"dloss = {(26.0 + m['dloss']) / 3:.3f} ")
    events = [json.loads(line) for line in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [{k: v for k, v in e.items() if k != "time"}
            for e in events if "event" in e] == [
        {"event": "resume", "epoch": 1},
        {"event": "resume_step", "epoch": 1, "opt_steps": 2}]


# --------------------------------------------- (iv) one step against JAX's

def test_step_after_the_resume_matches_the_jax_step(variables, tmp_path,
                                                    monkeypatch):
    """One port step from the restored state (torch Adam at step 7, the
    moments restored into it) against the JAX package's optax adam step
    from the same checkpoint."""
    form = "adam"
    jx, px, ja, _ = _configs()
    jstate = jax_state(variables, form)
    jckpt.save_checkpoint(jstate, str(tmp_path), PREFIX, EPOCH)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(12, CUT)) * 0.1).astype(np.float32)
    labels = np.array([0] * 6 + [1] * 6, np.int32)
    jcfg = JTrainConfig(lr=LR, cut=CUT, compactness_weight=0.1,
                        descriptiveness_weight=0.9,
                        rawboost=JRawBoostConfig(algo=0), **OPTIMIZERS[form])
    jstate = jstate.replace(apply_fn=JAModel(ja, xlsr_cfg=jx).apply)
    after, m = make_train_step(jcfg)(
        jstate, (jnp.asarray(x), jnp.asarray(labels)), jax.random.PRNGKey(1))
    after = jax.tree_util.tree_map(np.asarray, after)
    cfg = train_cfg(tmp_path, form)
    ref = create_train_state(bridged(port_model(2), variables, px), cfg)
    noise = _noise_masks(ref, torch.from_numpy(x),
                         torch.from_numpy(labels).long(), cfg)
    state, metrics = resumed(port_model(1), Batches([(x, labels)]), cfg,
                             monkeypatch)
    assert len(metrics) == 1
    assert metrics[0]["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert state.step == STEP + 1
    assert state.optimizer_state()["count"] == STEP + 1
    _assert_state_matches(state.model, after, noise)


# ----------------------------------------- (v) the newest across formats

def _fake_jax(directory, name, progress=None):
    """A JAX trainer directory of a one-leaf state (what find_resume reads
    of it is its name and progress)."""
    state = types.SimpleNamespace(
        params={"w": np.zeros(3, np.float32)}, batch_stats={},
        opt_state=FusedAdamState(np.int32(0), {"w": np.zeros(3, np.float32)},
                                 {"w": np.zeros(3, np.float32)}),
        step=np.int32(0))
    if progress is None:
        jckpt.save_checkpoint(state, str(directory), PREFIX,
                              int(name.rsplit("_", 1)[1]))
    else:
        jckpt.save_step_checkpoint(state, str(directory), PREFIX, progress)


def _progress(epoch, opt_steps):
    return {"epoch": epoch, "dispatches": opt_steps, "opt_steps": opt_steps,
            "running_loss": 0.0, "running_closs": 0.0, "running_dloss": 0.0}


@pytest.mark.parametrize("files, want_epoch, want_step", [
    ({"_0": None, "_1.pt": None}, "_1.pt", None),
    ({"_step_5": (1, 5), "_0.pt": None}, "_0.pt", "_step_5"),
    ({"_2": None, "_2.pt": None, "_step_4": (3, 4), "_step_4.pt": (3, 4)},
     "_2.pt", "_step_4.pt"),
    ({"_0": None, "_step_5": (1, 5), "_1.pt": None, "_step_2.pt": (2, 2)},
     "_1.pt", "_step_2.pt"),
], ids=["jax_epoch_then_pt", "jax_step_after_pt", "tie", "continued"])
def test_newest_checkpoint_wins_across_formats(tmp_path, files, want_epoch,
                                               want_step):
    """`continued`: a port run that continued from JAX's `_step_5/` and
    finished epoch 1 (`_1.pt`), then saved `_step_2.pt` in epoch 2."""
    for name, prog in files.items():
        if name.endswith(".pt"):
            payload = {} if prog is None else {"progress": _progress(*prog)}
            torch.save(payload, tmp_path / f"{PREFIX}{name}")
        else:
            _fake_jax(tmp_path, name,
                      None if prog is None else _progress(*prog))
    epoch, step = find_resume(str(tmp_path), PREFIX)
    assert os.path.basename(epoch.path) == PREFIX + want_epoch
    assert epoch.jax == (not want_epoch.endswith(".pt"))
    if want_step is None:
        assert step is None
    else:
        assert os.path.basename(step.path) == PREFIX + want_step
        assert step.jax == (not want_step.endswith(".pt"))


# --------------------------------------------------- (vi) mismatches raise

def _mismatch(case, variables, fused_variables):
    """(the JAX state written, this run's optimizer form, the pattern the
    error must hold)."""
    if case == "fused_under_adam":
        return jax_state(variables, "fused_adam"), "adam", \
            r"FusedAdamState.*--optimizer adam --lr_schedule constant"
    if case == "constant_under_cosine":
        return jax_state(variables, "adam"), "adam_schedule", \
            r"constant lr.*--lr_schedule cosine"
    if case == "schedule_count":
        return jax_state(variables, "adam_schedule", sched_count=6), \
            "adam_schedule", "the lr schedule's count 6 is not Adam's count 7"
    if case == "missing_moment":
        state = jax_state(variables, "adam")
        mu = jax.tree_util.tree_map(lambda a: a, state.opt_state[0].mu)
        del mu["backend"]["LL"]["bias"]
        return state.replace(opt_state=(state.opt_state[0]._replace(mu=mu),
                                        state.opt_state[1])), "adam", \
            "opt_state mu has no leaf /backend/LL/bias"
    return jax_state(fused_variables("ssl_resnet34"), "adam"), "adam", \
        "is not a checkpoint of this model"


@pytest.mark.parametrize("case", [
    "fused_under_adam", "constant_under_cosine", "schedule_count",
    "missing_moment", "other_model"])
def test_mismatches_raise_before_any_step(variables, fused_variables,
                                          tmp_path, case):
    jstate, form, pattern = _mismatch(case, variables, fused_variables)
    jckpt.save_checkpoint(jstate, str(tmp_path), PREFIX, EPOCH)
    with pytest.raises(ValueError, match=pattern) as err:
        train(port_model(), Raising(), train_cfg(tmp_path, form),
              device="cpu", resume=True)
    assert str(tmp_path / f"{PREFIX}_{EPOCH}") in str(err.value)


@pytest.mark.parametrize("tree", ["save_params", "converter"])
def test_weights_only_directories_name_init_from(variables, tmp_path, tree):
    """A bare parameter tree (`save_params`) and a converter's {"params",
    "batch_stats"} hold no optimizer state: resume names --init_from."""
    path = str(tmp_path / f"{PREFIX}_0")
    if tree == "save_params":
        jckpt.save_params(variables["params"], path)
    else:
        jckpt.save_params({"params": variables["params"],
                           "batch_stats": variables["batch_stats"]}, path)
    with pytest.raises(ValueError, match="weights only") as err:
        train(port_model(), Raising(), train_cfg(tmp_path), device="cpu",
              resume=True)
    assert path in str(err.value) and "'opt_state'" in str(err.value)
    assert f"--init_from {path}" in str(err.value)


# ------------------------------------ (vii) the JAX directories are read only

def _hashes(directory):
    """{file: sha256} of every file under `directory`."""
    out = {}
    for d, _, names in os.walk(directory):
        for name in names:
            full = os.path.join(d, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, directory)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_jax_directories_are_unchanged_beside_the_ports_checkpoints(
        variables, tmp_path, monkeypatch):
    """A run continued from JAX's `_0/` saves step .pt files (every 2
    steps, the older ones pruned) and `_1.pt` beside it and beside an
    older JAX step directory: both directories keep every byte, and the
    next resume takes `_1.pt`."""
    protocol, train_dir, voc_dir = write_fixture(tmp_path)
    ckpt = tmp_path / "ckpt"
    jckpt.save_checkpoint(jax_state(variables, "adam"), str(ckpt), PREFIX, 0)
    jckpt.save_step_checkpoint(jax_state(variables, "adam", step=3),
                               str(ckpt), PREFIX, _progress(0, 3))
    before = {name: _hashes(ckpt / name) for name in
              (f"{PREFIX}_0", f"{PREFIX}_step_3")}
    cfg = train_cfg(ckpt, num_epochs=2, checkpoint_every_steps=2)
    resumed(port_model(),
            MetaBatchPipeline(PFDataset(protocol, train_dir, voc_dir,
                                        cut=CUT, seed=SEED), seed=SEED),
            cfg, monkeypatch, checkpoint_fn=lambda s, e: save_checkpoint(
                s, cfg.checkpoint_dir, PREFIX, e))
    assert sorted(os.listdir(ckpt)) == [
        f"{PREFIX}_0", f"{PREFIX}_1.pt", f"{PREFIX}_step_3",
        f"{PREFIX}_step_6.pt"]
    assert {name: _hashes(ckpt / name) for name in before} == before
    epoch, step = find_resume(str(ckpt), PREFIX)
    assert os.path.basename(epoch.path) == f"{PREFIX}_1.pt" and step is None


# ---------------------------------------- (viii) resumes train identically

def test_two_resumes_and_a_pt_of_the_restored_state_train_alike(
        variables, tmp_path, monkeypatch):
    """Dropouts (XLSR's and AASIST's) and RawBoost on: two resumes of one
    JAX directory give the same losses bit for bit, and so does the port's
    own .pt of the state the first restored (its generator as the JAX
    resume seeded it)."""
    _, px, _, _ = _configs()
    px = dataclasses.replace(px, dropout=0.1, attention_dropout=0.1)
    jckpt.save_checkpoint(jax_state(variables, "adam"), str(tmp_path / "j"),
                          PREFIX, EPOCH)
    rng = np.random.default_rng(4)
    batches = [((rng.normal(size=(12, CUT)) * 0.1).astype(np.float32),
                np.array([0] * 6 + [1] * 6, np.int64)) for _ in range(2)]
    restore = checkpoint.restore_jax_checkpoint
    os.makedirs(tmp_path / "pt")

    def and_save(state, path, cfg):
        progress = restore(state, path, cfg)
        torch.save(checkpoint._payload(state),
                   checkpoint.checkpoint_path(str(tmp_path / "pt"), PREFIX,
                                              EPOCH))
        return progress

    losses = []
    for run, where in (("first", "j"), ("second", "j"), ("pt", "pt")):
        if run == "first":
            monkeypatch.setattr(checkpoint, "restore_jax_checkpoint",
                                and_save)
        else:
            monkeypatch.setattr(checkpoint, "restore_jax_checkpoint",
                                restore)
        cfg = train_cfg(tmp_path / where, num_epochs=EPOCH + 2,
                        rawboost=RawBoostConfig(algo=5))
        _, metrics = resumed(port_model(1, AASISTConfig.tiny(), px),
                             Batches(batches), cfg, monkeypatch)
        losses.append([m["loss"] for m in metrics])
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert losses[1] == losses[0] and losses[2] == losses[0]


# ------------------------------------------------------ (ix), (x) the CLI

@pytest.fixture(scope="module")
def cli_variables():
    """Variables of the CLI's model: AModel(AASISTConfig(), XLSR tiny)."""
    return perturbed(fabricated(
        JAModel(JAASISTConfig(), xlsr_cfg=JXLSRConfig.tiny()),
        np.zeros((2, CUT), np.float32)))


def _cli_flags(root, ckpt):
    """An epoch of 6 steps (one a bonafide utterance) after the resume."""
    protocol, train_dir, voc_dir = write_fixture(root)
    return ["--xlsr_tiny", "--device", "cpu", "--cut", str(CUT),
            "--num_epochs", "2", "--train_protocol_file", protocol,
            "--train_dataset_dir", train_dir, "--vocoded_dir", voc_dir,
            "--checkpoint_dir", str(ckpt), "--resume"]


def test_cli_resume_continues_a_jax_run(cli_variables, tmp_path,
                                        monkeypatch):
    """`oc_training --device cpu --resume` beside JAX's `_0/`: epoch 1's 6
    steps from step 7, `_1.pt` written, the resume event logged."""
    ckpt = tmp_path / "ckpt"
    jckpt.save_checkpoint(jax_state(cli_variables, "adam"), str(ckpt),
                          PREFIX, 0)
    monkeypatch.chdir(tmp_path)
    state = oc_training.main(_cli_flags(tmp_path, ckpt))
    assert state.step == STEP + 6
    assert sorted(os.listdir(ckpt)) == [f"{PREFIX}_0", f"{PREFIX}_1.pt"]
    events = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert {"event": "resume", "epoch": 1} in [
        {k: v for k, v in e.items() if k != "time"} for e in events]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_resume_on_a_tp2_mesh_of_two_gloo_ranks(cli_variables,
                                                     tmp_path, monkeypatch):
    """`oc_training --tp 2 --resume` over two Gloo ranks: each rank restores
    JAX's `_0/` whole and trains its shards; rank 0's `_1.pt` (step 13)
    holds parameters within Adam's reach (6 steps of 2 * lr) of the
    one-process resume's."""
    from occm_tpu_torch.models import load_reference_state_dict

    one, two = tmp_path / "one", tmp_path / "two"
    for root in (one, two):
        os.makedirs(root / "ckpt")
        jckpt.save_checkpoint(jax_state(cli_variables, "adam"),
                              str(root / "ckpt"), PREFIX, 0)
    flags = _cli_flags(two, two / "ckpt") + ["--tp", "2"]
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "occm_tpu_torch.cli.oc_training", *flags],
        cwd=two, env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                          WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=port, OMP_NUM_THREADS="1",
                          PYTHONPATH=os.path.dirname(TESTS)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    monkeypatch.chdir(one)
    oc_training.main(_cli_flags(one, one / "ckpt"))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    assert sorted(os.listdir(two / "ckpt")) == [f"{PREFIX}_0",
                                                 f"{PREFIX}_1.pt"]
    got = torch.load(two / "ckpt" / f"{PREFIX}_1.pt", weights_only=True)
    want = torch.load(one / "ckpt" / f"{PREFIX}_1.pt", weights_only=True)
    assert got["step"] == want["step"] == STEP + 6
    assert got["optimizer"]["count"] == STEP + 6
    lr = TrainConfig().lr
    for k, w in load_reference_state_dict(
            str(one / "ckpt" / f"{PREFIX}_1.pt")).items():
        if w.is_floating_point() and not k.endswith(
                ("pos_conv.0.weight_g", "running_mean", "running_var")):
            assert (got["model"][k] - w).abs().max() <= 12 * lr + 1e-6, k


# ------------------------------------------ chip_smoke's JAX-layout writer

def _tree_types(path):
    """{tree path: value type} of an orbax directory's _METADATA."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)["tree_metadata"]
    return {k: v["value_metadata"]["value_type"] for k, v in meta.items()}


def _assert_same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}/{i}")
    elif a is None:
        assert b is None, where
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where


@pytest.mark.parametrize("form, step_dir", [
    ("adam", False), ("fused_adam", True), ("adam_schedule", False)],
    ids=["epoch_adam", "step_fused_adam", "epoch_adam_schedule"])
def test_chip_smoke_writer_matches_the_jax_saver(variables, tmp_path, form,
                                                step_dir):
    """chip_smoke's write_jax_checkpoint of the port's state bridged from a
    JAX state, against the JAX package's save_checkpoint /
    save_step_checkpoint of that state: the same _METADATA tree paths and
    value types, and restore_tree of both equal leaf for leaf; the JAX
    package restores the writer's directory through its own template."""
    import chip_smoke

    _, px, _, pa = _configs()
    v = variables
    jstate = jax_state(v, form)
    progress = _progress(1, 2) if step_dir else None
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    if step_dir:
        want = jckpt.save_step_checkpoint(jstate, str(jdir), PREFIX, progress)
    else:
        want = jckpt.save_checkpoint(jstate, str(jdir), PREFIX, 0)
    cfg = train_cfg(tmp_path, form)
    state = create_train_state(bridged(port_model(0, pa, px), v, px), cfg)
    state.load_optimizer_state(
        optimizer_state_from_flax(jstate.opt_state, px))
    state.set_step(STEP)
    os.makedirs(pdir)
    got = chip_smoke.write_jax_checkpoint(state, str(pdir), PREFIX, px,
                                          progress=progress)
    assert os.path.basename(got) == os.path.basename(want)
    assert _tree_types(got) == _tree_types(want)
    _assert_same_tree(restore_tree(want), restore_tree(got))
    restored, _ = (jckpt.restore_step_checkpoint(jstate, str(pdir), PREFIX,
                                                 2) if step_dir else
                   jckpt.restore_checkpoint(jstate, str(pdir), PREFIX, 0))
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
