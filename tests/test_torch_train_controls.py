"""The port's training controls against the JAX package: gradient
accumulation, lr schedules, step checkpoints and resume, and
steps_per_dispatch (`occm_tpu_torch.train`, `occm_tpu_torch.data`).

- accumulation (accum 2 and 4, weighted, ragged tails) on a BatchNorm-free
  model with SGD, against the port's big batch and the JAX package's
  accumulated step (rtol 2e-5, atol 1e-7 as tests/test_grad_accum.py;
  a ragged tail falls back to the one-pass step, bit for bit);
- the schedules against optax at every step (rtol 1e-6: the two cosines
  may differ by one fp32 rounding), and 3 steps of the tiny AModel under
  a cosine schedule against JAX (the tolerance of
  tests/test_torch_train.py::test_train_step_matches_jax, per step);
- a crash-resume and a SIGTERM save + resume, with dropout on and remat,
  bit-identical to an uninterrupted run (the JAX package's
  tests/test_step_checkpoint.py, kept fast here by a 3-layer encoder);
- chunk_batches against the JAX package's, and k chunked steps on the CPU
  against k single steps, bit for bit;
- optimizer_state_from_flax on a scheduled optax state.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import RawBoostConfig as JRawBoostConfig
from occm_tpu.config import TrainConfig as JTrainConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.train.loop import chunk_batches as j_chunk_batches
from occm_tpu.train.loop import make_optimizer as j_make_optimizer
from occm_tpu.train.loop import make_train_step
from occm_tpu.train.state import create_train_state as j_create_state
from occm_tpu_torch import losses
from occm_tpu_torch.config import (
    AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
from occm_tpu_torch.data import chunk_batches
from occm_tpu_torch.models import AModel, state_dict_from_flax
from occm_tpu_torch.models.convert import optimizer_state_from_flax
from occm_tpu_torch.train import create_train_state, train, train_step
from occm_tpu_torch.train.checkpoint import (
    latest_step_checkpoint, save_checkpoint)
from occm_tpu_torch.train.schedules import make_schedule
from occm_tpu_torch.train.state import TrainState
from occm_tpu_torch.utils.logging import MetricsLogger

ACCUM_CUT = 400


# ------------------------------------------------------ gradient accumulation

class JTinyDual(fnn.Module):
    """tests/test_grad_accum.py's BatchNorm- and dropout-free (emb, logits)
    model (BatchNorm statistics are per micro-batch by design)."""

    dim: int = 16

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = fnn.tanh(fnn.Dense(self.dim)(x.reshape(x.shape[0], -1)))
        return fnn.Dense(self.dim)(h), fnn.Dense(2)(h)


class TinyDual(torch.nn.Module):
    """The same model in PyTorch (Dense_0, Dense_1, Dense_2)."""

    def __init__(self, cut=ACCUM_CUT, dim=16):
        super().__init__()
        self.d0 = torch.nn.Linear(cut, dim)
        self.d1 = torch.nn.Linear(dim, dim)
        self.d2 = torch.nn.Linear(dim, 2)

    def forward(self, x, generator=None):
        h = torch.tanh(self.d0(x))
        return self.d1(h), self.d2(h)


def _accum_batch(groups, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(groups * 12, ACCUM_CUT).astype(np.float32)
    labels = np.tile(np.array([0] * 6 + [1] * 6, np.int64), groups)
    return x, labels


def _accum_cfg(**kw):
    return TrainConfig(lr=1e-3, cut=ACCUM_CUT, compactness_weight=0.3,
                       descriptiveness_weight=0.7, **kw)


def _jax_accum_step(cfg, x, labels, weights=None):
    """The JAX package's step (SGD 1e-2, as tests/test_grad_accum.py) from
    JTinyDual's seed-0 init: (initial params, new params, metrics)."""
    jcfg = JTrainConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("rawboost", "mesh")})
    state = j_create_state(JTinyDual(), jax.random.PRNGKey(0),
                           jnp.asarray(x), optax.sgd(1e-2))
    p0 = jax.device_get(state.params)
    batch = (jnp.asarray(x), jnp.asarray(labels, jnp.int32))
    if weights is not None:
        batch = batch + (jnp.asarray(weights),)
    new, metrics = make_train_step(jcfg)(state, batch, jax.random.PRNGKey(1))
    return p0, jax.device_get(new.params), jax.device_get(metrics)


def _port_accum_step(cfg, x, labels, p0, weights=None):
    """The port's train_step from the JAX init p0 with torch SGD 1e-2:
    (new params by JAX name, metrics)."""
    model = TinyDual()
    with torch.no_grad():
        for i, lin in enumerate((model.d0, model.d1, model.d2)):
            lin.weight.copy_(torch.from_numpy(
                np.asarray(p0[f"Dense_{i}"]["kernel"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(
                np.array(p0[f"Dense_{i}"]["bias"])))
    state = TrainState(model=model,
                       optimizer=torch.optim.SGD(model.parameters(), 1e-2),
                       generator=torch.Generator())
    metrics = train_step(state, torch.from_numpy(x), torch.from_numpy(labels),
                         cfg, None if weights is None
                         else torch.from_numpy(weights))
    params = {f"Dense_{i}": {"kernel": lin.weight.detach().numpy().T,
                             "bias": lin.bias.detach().numpy()}
              for i, lin in enumerate((model.d0, model.d1, model.d2))}
    return params, {k: float(v) for k, v in metrics.items()}


def _assert_close(a, b, **tol):
    for k in a:
        if isinstance(a[k], dict):
            _assert_close(a[k], b[k], **tol)
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_equals_big_batch_and_jax(accum):
    x, labels = _accum_batch(4)
    big_cfg = _accum_cfg(groups_per_step=4)
    cfg = _accum_cfg(groups_per_step=4, grad_accum=accum)
    p0, jp, jm = _jax_accum_step(cfg, x, labels)
    big, big_m = _port_accum_step(big_cfg, x, labels, p0)
    got, got_m = _port_accum_step(cfg, x, labels, p0)
    for want, want_m in ((big, big_m), (jp, jm)):
        _assert_close(got_m, {k: float(v) for k, v in want_m.items()},
                      rtol=1e-5, atol=1e-7)
        _assert_close(got, want, rtol=2e-5, atol=1e-7)


def test_accum_equals_big_batch_weighted():
    """The last meta-batch is padding (weight 0): one micro-batch is all
    padding (its share r_i = 0) and the update is still the big weighted
    batch's, and JAX's."""
    x, labels = _accum_batch(4)
    w = np.concatenate([np.ones(36, np.float32), np.zeros(12, np.float32)])
    cfg = _accum_cfg(groups_per_step=4, grad_accum=4)
    p0, jp, jm = _jax_accum_step(cfg, x, labels, w)
    big, big_m = _port_accum_step(_accum_cfg(groups_per_step=4), x, labels,
                                  p0, w)
    got, got_m = _port_accum_step(cfg, x, labels, p0, w)
    for want, want_m in ((big, big_m), (jp, jm)):
        _assert_close(got_m, {k: float(v) for k, v in want_m.items()},
                      rtol=1e-5, atol=1e-7)
        _assert_close(got, want, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("tail_groups", [1, 3, 5])
def test_accum_ragged_tail_falls_back(tail_groups):
    """A tail batch whose group count grad_accum does not divide takes the
    one-pass step: the same bits as grad_accum = 1."""
    x, labels = _accum_batch(tail_groups)
    p0 = _jax_accum_step(_accum_cfg(groups_per_step=6), x, labels)[0]
    big, big_m = _port_accum_step(_accum_cfg(groups_per_step=6), x, labels,
                                  p0)
    got, got_m = _port_accum_step(
        _accum_cfg(groups_per_step=6, grad_accum=2), x, labels, p0)
    assert got_m == big_m
    _assert_close(got, big, rtol=0, atol=0)


# ------------------------------------------------------------ lr schedules

SCHEDULES = [("cosine", 10, 90, 0.1), ("cosine", 0, 20, 0.0),
             ("cosine", 1, 5, 0.0), ("linear", 4, 8, 0.5),
             ("linear", 0, 10, 0.0)]


@pytest.mark.parametrize("kind,warmup,decay,ratio", SCHEDULES)
def test_schedules_match_optax(kind, warmup, decay, ratio):
    kw = dict(lr=1e-3, lr_schedule=kind, warmup_steps=warmup,
              decay_steps=decay, lr_end_ratio=ratio)
    _, want = j_make_optimizer(JTrainConfig(**kw))
    got = make_schedule(TrainConfig(**kw))
    for t in range(warmup + decay + 5):
        np.testing.assert_allclose(got(t), float(want(jnp.int32(t))),
                                   rtol=1e-6, atol=0, err_msg=str(t))
    assert make_schedule(TrainConfig(lr=1e-3)) is None


def _amodel_configs():
    jx = dataclasses.replace(JXLSRConfig.tiny(), encoder_embed_dim=128,
                             attention_impl="flash", ln_impl="pallas")
    px = dataclasses.replace(XLSRConfig.tiny(), encoder_embed_dim=128,
                             attention_impl="flash", ln_impl="pallas")
    ja = dataclasses.replace(JAASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    pa = dataclasses.replace(AASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    return jx, px, ja, pa


SCHED_KW = dict(lr=1e-3, cut=3200, compactness_weight=0.1,
                descriptiveness_weight=0.9, lr_schedule="cosine",
                warmup_steps=1, decay_steps=5)


def _port_from_jax(jstate, step, cfg):
    """A port TrainState at JAX's state: weights and BatchNorm statistics
    bridged, Adam's moments and count through optimizer_state_from_flax."""
    _, px, _, pa = _amodel_configs()
    model = AModel(pa, px)
    model.load_state_dict(state_dict_from_flax(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}), px),
        strict=True)
    state = create_train_state(model, cfg)
    if step:
        state.load_optimizer_state(optimizer_state_from_flax(
            jax.device_get(jstate.opt_state), px))
    state.step = step
    return state


def _noise(model, x, labels):
    """{name: mask} of the entries whose gradient at the current weights is
    below 1e-6 of the largest (zero up to float noise); BatchNorm
    statistics are left as they were."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    emb, logits = model.train()(x)
    losses.group_one_class_loss(emb, logits, labels, 0.1, 0.9)[0].backward()
    top = max(float(p.grad.abs().max()) for p in model.parameters()
              if p.grad is not None)
    noise = {n: (p.grad.abs() < 1e-6 * top).numpy()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.load_state_dict(saved)
    return noise


def test_cosine_schedule_steps_track_jax():
    """3 steps of the tiny AModel (flash attention, Pallas LayerNorm; JAX in
    interpret mode) under a cosine schedule with one warmup step: each
    port step starts from JAX's state before it (Adam's moments through
    optimizer_state_from_flax of the scheduled optax state) and takes the
    schedule's lr at its step count (0 for the first), and is held as
    test_train_step_matches_jax holds a step: the loss to 1e-5 relative;
    every weight within 2 * lr + 1e-6 of JAX's, and at most 0.1 % of
    those whose gradient is not float noise off by more than 1e-6;
    BatchNorm statistics to 1e-5. Every step takes the same batch, as
    test_step_from_jax_state_through_optimizer_state_from_flax does: then
    Adam's later updates stay near lr * sign(g). With independent batches
    the second update's m / sqrt(v) amplifies the two sides' fp32 gradient
    differences wherever the two gradients cancel (4 % of the entries
    moved by more than 1e-6 there, at most 6e-5, 6 % of lr)."""
    jx, px, ja, pa = _amodel_configs()
    jcfg = JTrainConfig(rawboost=JRawBoostConfig(algo=0), **SCHED_KW)
    cfg = TrainConfig(**SCHED_KW)
    tx, sched = j_make_optimizer(jcfg)
    jstate = j_create_state(JAModel(ja, xlsr_cfg=jx), jax.random.PRNGKey(0),
                            jnp.zeros((12, 3200), jnp.float32), tx)
    jstep = make_train_step(jcfg)
    rng = np.random.default_rng(0)
    labels = np.array([0] * 6 + [1] * 6, np.int64)
    lrs = []
    x = (rng.normal(size=(12, 3200)) * 0.1).astype(np.float32)
    for i in range(3):
        state = _port_from_jax(jstate, i, cfg)
        xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
        noise = _noise(state.model, xt, lt)
        lr = state.schedule(state.step)
        assert lr == pytest.approx(float(sched(i)), rel=1e-6)
        lrs.append(lr)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(labels)),
                           jax.random.PRNGKey(i + 1))
        m = train_step(state, xt, lt, cfg)
        assert state.step == i + 1
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5)
        _assert_matches(state.model, jstate, noise, 2 * lr + 1e-6)
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(1e-3)


def _assert_matches(model, jstate, noise, bound):
    _, px, _, _ = _amodel_configs()
    want = state_dict_from_flax(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}), px)
    got = model.state_dict()
    n_far = n_all = 0
    for k, w in want.items():
        if "num_batches_tracked" in k or k.endswith("pos_conv.0.weight_g"):
            continue
        g = got[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-5, err_msg=k)
            continue
        name = k[:-2] if k.endswith("pos_conv.0.weight_v") else k
        diff = np.abs(g - w.numpy())
        assert diff.max() <= bound, k
        if name in noise:
            diff = diff[~noise[name]]
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_all > 0 and n_far <= 1e-3 * n_all, (n_far, n_all)


def test_optimizer_state_from_flax_takes_a_scheduled_optax_state():
    """optax.adam under a schedule keeps (ScaleByAdamState,
    ScaleByScheduleState): the bridge reads the Adam moments and count,
    the positional conv's under its folded kernel, and the port's "adam"
    takes them."""
    jx, px, ja, pa = _amodel_configs()
    tx, _ = j_make_optimizer(JTrainConfig(**SCHED_KW))
    jstate = j_create_state(JAModel(ja, xlsr_cfg=jx), jax.random.PRNGKey(0),
                            jnp.zeros((12, 3200), jnp.float32), tx)
    grads = jax.tree_util.tree_map(jnp.ones_like, jstate.params)
    for _ in range(2):
        updates, opt_state = tx.update(grads, jstate.opt_state,
                                       jstate.params)
        jstate = jstate.replace(opt_state=opt_state)
    assert type(jstate.opt_state[1]).__name__ == "ScaleByScheduleState"
    opt = optimizer_state_from_flax(jax.device_get(jstate.opt_state), px)
    assert opt["count"] == 2
    pos = "ssl_model.model.encoder.pos_conv.0.weight"
    want = np.asarray(jstate.opt_state[0].mu["ssl_model"]["pos_conv"][
        "kernel"]).transpose(2, 1, 0)
    np.testing.assert_array_equal(opt["mu"][pos].numpy(), want)
    state = create_train_state(AModel(pa, px), TrainConfig(**SCHED_KW))
    state.load_optimizer_state(opt)
    got = state.optimizer_state()
    assert got["count"] == 2
    assert set(got["mu"]) == set(opt["mu"])
    np.testing.assert_array_equal(got["nu"][pos].numpy(),
                                  opt["nu"][pos].numpy())


# ------------------------------------------- step checkpoints and resume

RESUME_CUT = 3200


class FakePipeline:
    """A seeded stream of [12, cut] batches per epoch; optionally raises,
    or sends this process SIGTERM, before yielding batch `disturb_after`."""

    def __init__(self, n_batches, disturb_after=None, disturb=None):
        self.n = n_batches
        self.disturb_after = disturb_after
        self.disturb = disturb

    def epoch(self, epoch):
        gen = np.random.default_rng(1000 + epoch)
        labels = np.array([0] * 6 + [1] * 6, np.int64)
        for i in range(self.n):
            if i == self.disturb_after:
                if self.disturb == "crash":
                    raise RuntimeError("synthetic preemption")
                os.kill(os.getpid(), signal.SIGTERM)
                self.disturb_after = None  # deliver once
            yield (gen.normal(size=(12, RESUME_CUT)).astype(np.float32)
                   * 0.1, labels)


def _resume_cfg(tmp_path, tag, every=2, k=1):
    return TrainConfig(
        lr=1e-3, num_epochs=1, compactness_weight=0.1,
        descriptiveness_weight=0.9, cut=RESUME_CUT, groups_per_step=1,
        checkpoint_dir=str(tmp_path / tag), checkpoint_prefix="aasist_vocoded",
        loss_txt=str(tmp_path / f"loss_{tag}.txt"), log_every=100,
        checkpoint_every_steps=every, steps_per_dispatch=k,
        rawboost=RawBoostConfig(algo=0))


def _resume_model():
    """The tiny AModel with dropout on at every site (AASIST's defaults,
    XLSR's three rates) and remat."""
    torch.manual_seed(0)
    xcfg = dataclasses.replace(XLSRConfig.tiny(), encoder_layers=3,
                               dropout=0.1, attention_dropout=0.1,
                               activation_dropout=0.1, remat=True)
    return AModel(AASISTConfig.tiny(), xcfg)


def _run(cfg, pipeline, resume=False):
    def checkpoint_fn(state, epoch):
        save_checkpoint(state, cfg.checkpoint_dir, cfg.checkpoint_prefix,
                        epoch)

    logger = MetricsLogger(cfg.loss_txt, None)
    return train(_resume_model(), pipeline, cfg, logger=logger,
                 checkpoint_fn=checkpoint_fn, device="cpu", resume=resume)


def _assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer_state(), b.optimizer_state()
    assert oa["count"] == ob["count"]
    for part in ("mu", "nu"):
        for k in oa[part]:
            assert torch.equal(oa[part][k], ob[part][k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The uninterrupted run of 5 batches (saving step checkpoints does not
    change the trajectory, so one run serves every resume test)."""
    return _run(_resume_cfg(tmp_path_factory.mktemp("ref"), "ref", every=0),
                FakePipeline(5))


def test_crash_resume_is_bit_identical(tmp_path, uninterrupted):
    """A run that dies fetching batch 4 of 5 has a step checkpoint at
    optimizer step 2; --resume restores it, replays the epoch's first two
    dispatches without running them, and ends bit-identical to the
    uninterrupted run (dropout masks included)."""
    cfg = _resume_cfg(tmp_path, "pre")
    with pytest.raises(RuntimeError, match="synthetic preemption"):
        _run(cfg, FakePipeline(5, disturb_after=3, disturb="crash"))
    assert latest_step_checkpoint(cfg.checkpoint_dir,
                                  cfg.checkpoint_prefix) == 2
    resumed = _run(cfg, FakePipeline(5), resume=True)
    _assert_states_equal(resumed, uninterrupted)


def test_sigterm_saves_and_resume_is_bit_identical(tmp_path, uninterrupted):
    """A SIGTERM mid-epoch saves one step checkpoint at the next dispatch
    boundary (off the every-N grid) and train() returns, restoring the
    previous handler; --resume finishes the epoch bit-identically."""
    cfg = _resume_cfg(tmp_path, "sig", every=100)
    before = signal.getsignal(signal.SIGTERM)
    state = _run(cfg, FakePipeline(5, disturb_after=3, disturb="sigterm"))
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 4
    assert latest_step_checkpoint(cfg.checkpoint_dir,
                                  cfg.checkpoint_prefix) == 4
    assert not os.path.exists(os.path.join(cfg.checkpoint_dir,
                                           "aasist_vocoded_0.pt"))
    resumed = _run(cfg, FakePipeline(5), resume=True)
    _assert_states_equal(resumed, uninterrupted)


def test_step_checkpoint_keeps_only_newest_and_epoch_resume_wins(tmp_path):
    """Every step checkpoint replaces the previous one (deleted after the
    save), and once the epoch checkpoint exists --resume starts the next
    epoch from it."""
    cfg = dataclasses.replace(_resume_cfg(tmp_path, "prune", every=1),
                              num_epochs=2)
    seen = []

    def listing(step, metrics):
        seen.append(sorted(n for n in os.listdir(cfg.checkpoint_dir)
                           if "_step_" in n))

    logger = MetricsLogger(cfg.loss_txt, None)
    os.makedirs(cfg.checkpoint_dir)
    train(_resume_model(), FakePipeline(3), dataclasses.replace(
        cfg, num_epochs=1), logger=logger, device="cpu",
        checkpoint_fn=lambda s, e: save_checkpoint(
            s, cfg.checkpoint_dir, cfg.checkpoint_prefix, e),
        on_step=listing)
    # on_step runs before the save: step n sees step n-1's file only
    assert seen == [[], ["aasist_vocoded_step_1.pt"],
                    ["aasist_vocoded_step_2.pt"]]
    assert latest_step_checkpoint(cfg.checkpoint_dir,
                                  cfg.checkpoint_prefix) == 3
    state = _run(cfg, FakePipeline(3), resume=True)
    assert state.step == 6  # epoch 1 ran from the epoch-0 checkpoint


# ------------------------------------------------------- steps_per_dispatch

def _stream(sizes):
    for i, n in enumerate(sizes):
        yield np.full((n, 4), i, np.float32), np.zeros((n,), np.int32)


@pytest.mark.parametrize("sizes,k", [
    ([12, 12, 12, 7, 12, 12], 2), ([12] * 7, 3), ([5, 12, 12], 1)])
def test_chunk_batches_matches_jax_and_keeps_order(sizes, k):
    got = list(chunk_batches(_stream(sizes), 12, k))
    want = list(j_chunk_batches(_stream(sizes), 12, k))
    assert [g[0] for g in got] == [w[0] for w in want]
    order = []
    for (kind, x, l), (_, jx, jl) in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(l, np.asarray(jl))
        assert l.dtype == np.int64
        order.extend(x[:, 0, 0] if kind == "chunk" else [x[0, 0]])
    assert [int(i) for i in order] == list(range(len(sizes)))
    if sizes[3:4] == [7]:
        assert [g[0] for g in got] == ["chunk", "single", "single", "chunk"]


def test_chunked_steps_on_the_cpu_equal_single_steps(tmp_path):
    """steps_per_dispatch = 2 on the CPU over 5 full batches and a ragged
    one (chunk, chunk, single, single): the same bits as 6 single steps,
    one on_step call per dispatch with the chunk's mean loss, and the same
    loss.txt counter."""
    class Pipeline:
        def epoch(self, epoch):
            gen = np.random.default_rng(7)
            labels = np.tile(np.array([0] * 6 + [1] * 6, np.int64), 2)
            for n in (12, 12, 12, 12, 12, 24):
                yield ((gen.normal(size=(n, RESUME_CUT)) * 0.1)
                       .astype(np.float32), labels[:n])

    runs = {}
    for k in (1, 2):
        cfg = dataclasses.replace(_resume_cfg(tmp_path, f"k{k}", every=0,
                                              k=k), log_every=2)
        calls = []
        runs[k] = (train(_resume_model(), Pipeline(), cfg,
                         logger=MetricsLogger(cfg.loss_txt, None),
                         device="cpu",
                         on_step=lambda s, m: calls.append((s, m))), calls)
    _assert_states_equal(runs[2][0], runs[1][0])
    singles, chunks = runs[1][1], runs[2][1]
    assert [s for s, _ in chunks] == [2, 4, 5, 6]
    for i in range(2):
        pair = [float(singles[2 * i + j][1]["loss"]) for j in range(2)]
        np.testing.assert_array_equal(
            chunks[i][1]["step_loss"].numpy(), np.float32(pair))
        assert float(chunks[i][1]["loss"]) == pytest.approx(np.mean(pair),
                                                            rel=1e-6)
    logs = [open(tmp_path / f"loss_k{k}.txt").read().splitlines()
            for k in (1, 2)]
    assert [line.split(", loss")[0] for line in logs[0]] == \
        [line.split(", loss")[0] for line in logs[1]]
