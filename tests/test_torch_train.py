"""The port's training slice (`occm_tpu_torch.losses`, `.data`, `.train`,
`.cli.oc_training`, train-mode `.models`) against the JAX package.

- losses and group_one_class_loss on the same numpy inputs (rtol 1e-6);
- the meta-batch data path yields byte-identical batches for one seed;
- one train step of a tiny AModel from bridged weights, every kernel's
  route on (flash attention, ln_impl="pallas", fused_adam; the JAX side's
  Pallas kernels in interpret mode, the port's plain versions), against
  JAX make_train_step, then a second step from the JAX state after step 1
  through optimizer_state_from_flax;
- RawBoost in the step (drawn from the state's generator before the
  dropout masks), the dropout sites, and the CLI on the CPU.

Step tolerances: the loss to 1e-5 relative (fp32, the same forward in
another summation order). Adam's first update is lr * g / (|g| + eps), so
parameters agree to 1e-6 where the two gradients agree in sign. Where the
gradient is zero up to float noise, Adam turns the noise into a full step
of either sign: the biases that feed a train-mode BatchNorm (which removes
their effect) and the key projection's bias (softmax ignores it) have
exactly zero gradient. Entries whose port gradient is below 1e-6 of the
largest are therefore only held to the 2 * lr + 1e-6 that one step can
move them; of the rest at most 0.1 % (near-zero gradients of either sign)
may differ by more than 1e-6. Both train the positional conv's folded
kernel, so it is held like every other parameter. BatchNorm running means
and variances agree to 1e-5 (both update the variance with the biased
batch variance).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import MeshConfig as JMeshConfig
from occm_tpu.config import RawBoostConfig as JRawBoostConfig
from occm_tpu.config import TrainConfig as JTrainConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.data import MetaBatchPipeline as JMetaBatchPipeline
from occm_tpu.data import PFDataset as JPFDataset
from occm_tpu.losses import compactness_loss as j_compactness
from occm_tpu.losses import descriptiveness_loss as j_descriptiveness
from occm_tpu.losses import one_class_loss as j_one_class_loss
from occm_tpu.models import AModel as JAModel
from occm_tpu.train.loop import group_one_class_loss as j_group_loss
from occm_tpu.train.loop import make_optimizer as j_make_optimizer
from occm_tpu.train.loop import make_train_step
from occm_tpu.train.state import create_train_state as j_create_state
from occm_tpu_torch import losses
from occm_tpu_torch.config import (
    AASISTConfig, MeshConfig, RawBoostConfig, TrainConfig, XLSRConfig)
from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
from occm_tpu_torch.io.wav import write_wav
from occm_tpu_torch.models import AModel, state_dict_from_flax
from occm_tpu_torch.models.convert import optimizer_state_from_flax
from occm_tpu_torch.models.xlsr import XLSREncoder, dropout
from occm_tpu_torch.train import create_train_state, train_step

SR = 16000
CUT = 3200
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch ops run on one thread: the models are tiny, and
    the suite's workers share the host's cores (oversubscribed, torch's
    worker threads spin: under six workers a 6-step CLI epoch here took
    ~250 s of wall time, alone 2-7 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VOCODERS = ("hifigan", "hn-sinc-nsf-hifi", "hn-sinc-nsf", "melgan",
            "waveglow")


def write_fixture(root, n_bona=6, n_spoof=2, seed=0):
    """A tiny ASVspoof-shaped tree (tests/test_cli_training.py's recipe)."""
    train_dir, voc_dir = root / "train", root / "vocoded"
    train_dir.mkdir()
    voc_dir.mkdir()
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_bona):
        utt = f"LA_T_b{i:04d}"
        n = int(rng.integers(2000, 4000))
        wave = 0.3 * np.sin(2 * np.pi * (220 + 20 * i) * np.arange(n) / SR)
        write_wav(str(train_dir / f"{utt}.wav"), wave, SR)
        lines.append(f"LA_{i:04d} {utt} - - bonafide")
        for voc in VOCODERS:
            write_wav(str(voc_dir / f"{voc}_{utt}.wav"),
                      wave + 0.05 * rng.normal(size=n), SR)
    for i in range(n_spoof):
        utt = f"LA_T_s{i:04d}"
        write_wav(str(train_dir / f"{utt}.wav"),
                  0.2 * rng.normal(size=2400), SR)
        lines.append(f"LA_{100 + i:04d} {utt} - A01 spoof")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return str(root / "train.txt"), str(train_dir), str(voc_dir)


# ------------------------------------------------------------------ losses

def _emb_logits(g=2, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(12 * g, 160)).astype(np.float32)
    logits = rng.normal(size=(12 * g, 2)).astype(np.float32)
    labels = np.tile(np.array([0] * 6 + [1] * 6), g).astype(np.int32)
    return emb, logits, labels


def test_compactness_and_descriptiveness_match_jax():
    emb, logits, labels = _emb_logits(g=1)
    np.testing.assert_allclose(
        losses.compactness_loss(torch.from_numpy(emb)).numpy(),
        np.asarray(j_compactness(jnp.asarray(emb))), rtol=1e-6)
    np.testing.assert_allclose(
        losses.descriptiveness_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels)).numpy(),
        np.asarray(j_descriptiveness(jnp.asarray(logits),
                                     jnp.asarray(labels))), rtol=1e-6)
    got, (c, d) = losses.one_class_loss(
        torch.from_numpy(emb), torch.from_numpy(logits),
        torch.from_numpy(labels), 0.1, 0.9)
    want, (jc, jd) = j_one_class_loss(jnp.asarray(emb), jnp.asarray(logits),
                                      jnp.asarray(labels), 0.1, 0.9)
    np.testing.assert_allclose([float(got), float(c), float(d)],
                               [float(want), float(jc), float(jd)],
                               rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_group_one_class_loss_matches_jax(weighted):
    emb, logits, labels = _emb_logits(g=3, seed=1)
    w = np.repeat(np.array([1.0, 0.0, 1.0], np.float32), 12) \
        if weighted else None
    got, (c, d) = losses.group_one_class_loss(
        torch.from_numpy(emb), torch.from_numpy(logits),
        torch.from_numpy(labels), 0.1, 0.9, 12,
        None if w is None else torch.from_numpy(w))
    want, (jc, jd) = j_group_loss(
        jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(labels), 0.1,
        0.9, 12, None if w is None else jnp.asarray(w))
    np.testing.assert_allclose([float(got), float(c), float(d)],
                               [float(want), float(jc), float(jd)],
                               rtol=1e-6)


# --------------------------------------------------------------- data path

def test_pipeline_yields_the_jax_packages_batches(tmp_path):
    protocol, train_dir, voc_dir = write_fixture(tmp_path)
    for pad_mode, groups in (("repeat", 4), ("group_max", 1)):
        jds = JPFDataset(protocol, train_dir, voc_dir, cut=CUT,
                         pad_mode=pad_mode, seed=3)
        ds = PFDataset(protocol, train_dir, voc_dir, cut=CUT,
                       pad_mode=pad_mode, seed=3)
        assert len(ds) == len(jds) == 6
        want = list(JMetaBatchPipeline(jds, groups_per_step=groups, seed=3,
                                       shard_index=0, shard_count=1)
                    .epoch(1))
        got = list(MetaBatchPipeline(ds, groups_per_step=groups, seed=3)
                   .epoch(1))
        assert len(got) == len(want) == -(-6 // groups)  # ragged tail kept
        for (x, l), (jx, jl) in zip(got, want):
            assert x.dtype == np.float32 and x.shape == np.shape(jx)
            assert x.tobytes() == np.asarray(jx, np.float32).tobytes()
            np.testing.assert_array_equal(l, jl)


def test_prefetcher_reraises_worker_errors():
    from occm_tpu_torch.data import Prefetcher

    def items():
        yield 1
        raise OSError("decode failed")

    it = Prefetcher(items())
    assert next(it) == 1
    with pytest.raises(OSError, match="decode failed"):
        next(it)


# ------------------------------------------------------------ train step

def _configs():
    jx = dataclasses.replace(JXLSRConfig.tiny(), encoder_embed_dim=128,
                             attention_impl="flash", ln_impl="pallas")
    px = dataclasses.replace(XLSRConfig.tiny(), encoder_embed_dim=128,
                             attention_impl="flash", ln_impl="pallas")
    ja = dataclasses.replace(JAASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    pa = dataclasses.replace(AASISTConfig.tiny(), dropout=0.0,
                             pool_dropout=0.0, head_dropout=0.0)
    return jx, px, ja, pa


@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX train steps of the tiny AModel (fused_adam, flash, Pallas
    LN, all in interpret mode) on one seeded batch: the initial, step-1
    and step-2 states and the two losses."""
    jx, _, ja, _ = _configs()
    cfg = JTrainConfig(optimizer="fused_adam", lr=LR, cut=CUT,
                       compactness_weight=0.1, descriptiveness_weight=0.9,
                       rawboost=JRawBoostConfig(algo=0))
    model = JAModel(ja, xlsr_cfg=jx)
    tx, _ = j_make_optimizer(cfg)
    state0 = j_create_state(model, jax.random.PRNGKey(0),
                            jnp.zeros((12, CUT), jnp.float32), tx)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(12, CUT)) * 0.1).astype(np.float32)
    labels = np.array([0] * 6 + [1] * 6, np.int32)
    step = make_train_step(cfg)
    snap = lambda s: jax.tree_util.tree_map(np.asarray, s)  # noqa: E731
    s0 = snap(state0)
    state1, m1 = step(state0, (jnp.asarray(x), jnp.asarray(labels)),
                      jax.random.PRNGKey(1))
    s1 = snap(state1)
    state2, m2 = step(state1, (jnp.asarray(x), jnp.asarray(labels)),
                      jax.random.PRNGKey(2))
    return dict(x=x, labels=labels, s0=s0, s1=s1, s2=snap(state2),
                loss1=float(m1["loss"]), loss2=float(m2["loss"]))


def _port_state(jstate):
    _, px, _, pa = _configs()
    model = AModel(pa, px)
    model.load_state_dict(state_dict_from_flax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, px),
        strict=True)
    cfg = TrainConfig(optimizer="fused_adam", lr=LR, cut=CUT,
                      compactness_weight=0.1, descriptiveness_weight=0.9,
                      rawboost=RawBoostConfig(algo=0))
    return create_train_state(model, cfg), cfg


def _noise_masks(state, x, labels, cfg):
    """{name: bool mask} of the entries whose gradient at the current
    weights is below 1e-6 of the largest (zero up to float noise); the
    model's BatchNorm statistics are left as they were."""
    model = state.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    emb, logits = model(x, generator=state.generator)
    loss, _ = losses.group_one_class_loss(
        emb, logits, labels, cfg.compactness_weight,
        cfg.descriptiveness_weight)
    loss.backward()
    grads = {n: p.grad.abs() for n, p in model.named_parameters()
             if p.grad is not None}
    top = max(float(g.max()) for g in grads.values())
    model.zero_grad(set_to_none=True)
    model.load_state_dict(saved)
    return {n: (g < 1e-6 * top).numpy() for n, g in grads.items()}


def _assert_state_matches(model, jstate, noise):
    _, px, _, _ = _configs()
    want = state_dict_from_flax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, px)
    got = model.state_dict()
    n_far = n_all = 0
    for k, w in want.items():
        g = got[k].detach()
        # the positional conv's state dict is (g, v) = (||w||, w): w, the
        # parameter both train, is held as v; g follows from it
        if "num_batches_tracked" in k or k.endswith("pos_conv.0.weight_g"):
            continue
        name = k[:-2] if k.endswith("pos_conv.0.weight_v") else k
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       err_msg=k)
        else:
            diff = np.abs(g.numpy() - w.numpy())
            assert diff.max() <= 2 * LR + 1e-6, k
            if name in noise:  # bn1 never runs: no gradient, never updated
                diff = diff[~noise[name]]
            n_far += int((diff > 1e-6).sum())
            n_all += diff.size
    assert n_all > 0 and n_far <= 1e-3 * n_all, (n_far, n_all)


def test_train_step_matches_jax(jax_steps):
    state, cfg = _port_state(jax_steps["s0"])
    x = torch.from_numpy(jax_steps["x"])
    labels = torch.from_numpy(jax_steps["labels"]).long()
    noise = _noise_masks(state, x, labels, cfg)
    metrics = train_step(state, x, labels, cfg)
    assert float(metrics["loss"]) == pytest.approx(jax_steps["loss1"],
                                                   rel=1e-5)
    assert state.step == 1 and state.optimizer.count == 1
    _assert_state_matches(state.model, jax_steps["s1"], noise)


def test_step_from_jax_state_through_optimizer_state_from_flax(jax_steps):
    """Port step 2 from JAX's state after step 1 (parameters, BatchNorm
    statistics and Adam moments bridged) against JAX's step 2."""
    s1 = jax_steps["s1"]
    state, cfg = _port_state(s1)
    opt = optimizer_state_from_flax(s1.opt_state, _configs()[1])
    assert opt["count"] == 1
    assert "ssl_model.model.encoder.pos_conv.0.weight" in opt["mu"]
    state.load_optimizer_state(opt)
    x = torch.from_numpy(jax_steps["x"])
    labels = torch.from_numpy(jax_steps["labels"]).long()
    noise = _noise_masks(state, x, labels, cfg)
    metrics = train_step(state, x, labels, cfg)
    assert float(metrics["loss"]) == pytest.approx(jax_steps["loss2"],
                                                   rel=1e-5)
    assert state.optimizer.count == 2
    _assert_state_matches(state.model, jax_steps["s2"], noise)


class _DropoutNet(torch.nn.Module):
    """(emb, logits) from 64 samples spread over the crop, through a
    dropout whose mask comes from the forward's generator (as the models'
    masks do)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.emb = torch.nn.Linear(64, 16)
        self.head = torch.nn.Linear(16, 2)

    def forward(self, x, generator=None):
        e = dropout(self.emb(x[:, ::CUT // 64]), 0.5, generator)
        return e, self.head(e)


def test_train_step_applies_rawboost_from_the_state_generator():
    """With RawBoost on, train_step augments the whole batch from
    state.generator before any dropout mask is drawn: the same step as one
    without RawBoost on batch_rawboost(generator, x), bit for bit, and a
    step repeated from the saved weights and generator state is
    bit-identical to itself."""
    from occm_tpu_torch.augment import batch_rawboost

    rb = RawBoostConfig(algo=5)
    cfgs = {algo: TrainConfig(lr=LR, cut=CUT, compactness_weight=0.1,
                              descriptiveness_weight=0.9,
                              rawboost=dataclasses.replace(rb, algo=algo))
            for algo in (0, 5)}
    x = _wave(3, n=12)
    labels = torch.tensor([0] * 6 + [1] * 6)

    def state_for(algo):
        return create_train_state(_DropoutNet(), cfgs[algo])

    on, off = state_for(5), state_for(0)
    gen0 = on.generator.get_state()
    m_on = train_step(on, x, labels, cfgs[5])
    x_aug = batch_rawboost(off.generator, x, rb)
    assert not torch.equal(x_aug, x)
    m_off = train_step(off, x_aug, labels, cfgs[0])
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert torch.equal(on.generator.get_state(), off.generator.get_state())
    for k, v in on.model.state_dict().items():
        assert torch.equal(v, off.model.state_dict()[k]), k
    again = state_for(5)
    again.generator.set_state(gen0)
    assert torch.equal(train_step(again, x, labels, cfgs[5])["loss"],
                       m_on["loss"])
    # the augmentation moved the step: without it the loss differs
    plain = state_for(0)
    plain.generator.set_state(gen0)
    assert not torch.equal(train_step(plain, x, labels, cfgs[0])["loss"],
                           m_on["loss"])


# ------------------------------------------------------------ dropout sites

def test_dropout_keeps_one_minus_p_and_scales():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.3, gen)
    kept = y != 0
    # binomial(200000, 0.7): 5 sigma is 0.005 of the fraction
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert dropout(x, 0.3, None) is x           # eval mode
    assert dropout(x, 0.0, gen) is x
    same = dropout(x, 0.3, torch.Generator().manual_seed(0))
    torch.testing.assert_close(same, y, rtol=0, atol=0)


def _tiny_encoder(**kw):
    torch.manual_seed(0)
    cfg = dataclasses.replace(XLSRConfig.tiny(), **kw)
    return XLSREncoder(cfg)


def _wave(seed=0, n=2):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=(n, CUT)) * 0.1).astype(np.float32))


def test_eval_mode_is_the_identity_of_every_dropout_site():
    rates = dict(dropout=0.3, attention_dropout=0.2, activation_dropout=0.2,
                 dropout_input=0.1, layerdrop=0.5)
    model = _tiny_encoder(**rates).eval()
    plain = _tiny_encoder().eval()
    x = _wave()
    with torch.no_grad():
        torch.testing.assert_close(model(x), plain(x), rtol=0, atol=0)
        model.train()
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)


def test_remat_recompute_reproduces_the_forward_masks():
    """With dropout on, the rematerialised layers (recomputed in the
    backward) give the outputs and gradients of the same model without
    remat: the recompute draws the forward's masks."""
    x = _wave(1)
    out, grads = [], []
    for remat in (False, True):
        model = _tiny_encoder(dropout=0.3, activation_dropout=0.2,
                              attention_dropout=0.2, remat=remat).train()
        y = model(x, generator=torch.Generator().manual_seed(3))
        y.square().sum().backward()
        out.append(y.detach())
        grads.append([p.grad for p in model.parameters()])
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=0)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_feature_grad_mult_scales_and_stops_the_extractor_gradient():
    x = _wave(2)
    conv = {}
    for mult in (1.0, 0.5, 0.0):
        model = _tiny_encoder(feature_grad_mult=mult, conv_remat=mult == 0.5)
        model.train()(x).square().sum().backward()
        conv[mult] = model.feature_extractor.conv_layers[0]["0"].weight.grad
    torch.testing.assert_close(conv[0.5], 0.5 * conv[1.0], rtol=1e-5,
                               atol=1e-7)
    assert conv[0.0] is None


def test_layerdrop_one_skips_every_layer():
    """layerdrop = 1 discards every layer with where(keep, y, x), as the
    JAX package does: the output is the layers' input, and every layer's
    parameters get a zero gradient."""
    model = _tiny_encoder(layerdrop=1.0).train()
    y = model(_wave(3), generator=torch.Generator().manual_seed(0))
    y.sum().backward()
    bare = _tiny_encoder(encoder_layers=0).train()
    bare.load_state_dict(model.state_dict(), strict=False)
    with torch.no_grad():
        torch.testing.assert_close(y.detach(), bare(_wave(3)), rtol=0,
                                   atol=0)
    for layer in model.encoder.layers:
        for p in layer.parameters():
            assert p.grad is not None and not p.grad.any()


def test_flash_attention_refuses_attention_dropout_in_training():
    model = _tiny_encoder(attention_impl="flash", attention_dropout=0.1)
    with torch.no_grad():
        model.eval()(_wave())          # eval: no dropout, no error
        with pytest.raises(ValueError, match="attention_dropout"):
            model.train()(_wave())


def test_aasist_dropout_sites():
    """Train-mode AASIST: the head dropout acts on the logits' input only
    (emb is returned before it), and zero rates give the batch-statistics
    forward whatever the generator."""
    torch.manual_seed(0)
    heavy = AModel(dataclasses.replace(AASISTConfig.tiny(), dropout=0.0,
                                       pool_dropout=0.0, head_dropout=0.9),
                   XLSRConfig.tiny())
    none = AModel(dataclasses.replace(AASISTConfig.tiny(), dropout=0.0,
                                      pool_dropout=0.0, head_dropout=0.0),
                  XLSRConfig.tiny())
    none.load_state_dict(heavy.state_dict())
    x = _wave(4, n=4)
    with torch.no_grad():
        e1, l1 = heavy.train()(x, generator=torch.Generator().manual_seed(5))
        e0, l0 = none.train()(x, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(e1, e0, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(l1, l0)
    full = AModel(AASISTConfig.tiny(), XLSRConfig.tiny())
    assert {m.p for m in full.modules()
            if type(m).__name__ == "GraphPool"} == {0.3}
    assert {m.dropout for m in full.modules()
            if hasattr(m, "dropout") and isinstance(m.dropout, float)} \
        == {0.2}


# ------------------------------------------------------------------- CLI

def _cli_args(protocol, train_dir, voc_dir, ckpt_dir, *extra):
    return ["--train_protocol_file", protocol,
            "--train_dataset_dir", train_dir, "--vocoded_dir", voc_dir,
            "--xlsr_tiny", "--device", "cpu", "--cut", str(CUT),
            "--num_epochs", "1", "--compactness_weight", "0.1",
            "--descriptiveness_weight", "0.9", "--checkpoint_dir", ckpt_dir,
            *extra]


class _FirstStep(Exception):
    """Ends a CLI run after its first step."""


@pytest.fixture(scope="module")
def cli_baseline(tmp_path_factory):
    """One CLI epoch on the fixture tree with no extra flag: its step
    losses, its step count, its final weights and its checkpoint."""
    from occm_tpu_torch.cli import oc_training

    root = tmp_path_factory.mktemp("cli_baseline")
    files = write_fixture(root)
    steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        state = oc_training.main(
            _cli_args(*files, str(root / "ck")),
            on_step=lambda step, m: steps.append(float(m["loss"])))
    return {"files": files, "losses": steps, "step": state.step,
            "checkpoint": root / "ck" / "aasist_vocoded_0.pt",
            "state_dict": {k: v.clone()
                           for k, v in state.model.state_dict().items()}}


def test_cli_trains_on_the_cpu_and_writes_a_servable_checkpoint(
        tmp_path, monkeypatch, cli_baseline):
    from occm_tpu_torch.cli import oc_server, oc_training

    monkeypatch.chdir(tmp_path)
    steps = cli_baseline["losses"]
    assert len(steps) == 6 and all(np.isfinite(steps))
    assert cli_baseline["step"] == 6
    path = cli_baseline["checkpoint"]
    assert path.is_file()
    model = oc_server.build_model(XLSRConfig.tiny(), str(path),
                                  allow_random_init=False, device="cpu")
    for k, v in cli_baseline["state_dict"].items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 6 and saved["optimizer"]["count"] == 6
    # a warm start from the checkpoint
    state2 = oc_training.main(
        _cli_args(*cli_baseline["files"], str(tmp_path / "ck2"),
                  "--init_from", str(path), "--num_epochs", "0"))
    for k, v in cli_baseline["state_dict"].items():
        torch.testing.assert_close(state2.model.state_dict()[k], v, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("extra, error", [
    (["--fsdp", "2"], ValueError),
    (["--debug_nans"], None),
    (["--wandb_project", "p"], None),
    (["--pos_conv_impl", "s2d"], None),
], ids=["fsdp", "debug_nans", "wandb_project", "pos_conv_impl"])
def test_cli_unported_flags_raise(tmp_path, monkeypatch, cli_baseline,
                                  extra, error):
    """--fsdp = 2 in one process, with no process group, does not cover
    its world of 1 and raises JAX's ValueError. The other flags are
    ported: on finite data --debug_nans and --wandb_project (with no wandb
    to import, the JAX package's fallback to loss.txt) train the run
    without them bit for bit; --pos_conv_impl s2d takes the first step
    of that run up to the layout's reassociation of the conv's sums (loss
    at rtol 1e-5; the run stops there: later steps drift further, as
    AASIST's top-k pools may pick other nodes; the layout's own parity is
    tests/test_torch_layouts.py's)."""
    from occm_tpu_torch.cli import oc_training

    monkeypatch.chdir(tmp_path)
    if error is not None:
        with pytest.raises(error):
            oc_training.main(_cli_args("p.txt", "t", "v", str(tmp_path),
                                       *extra))
        return
    steps = []

    def on_step(step, metrics):
        steps.append(float(metrics["loss"]))
        if extra[0] == "--pos_conv_impl":
            raise _FirstStep

    if extra[0] == "--pos_conv_impl":
        with pytest.raises(_FirstStep):
            oc_training.main(_cli_args(*cli_baseline["files"],
                                       str(tmp_path / "ck"), *extra),
                             on_step=on_step)
        assert steps[0] == pytest.approx(cli_baseline["losses"][0],
                                         rel=1e-5)
        return
    state = oc_training.main(
        _cli_args(*cli_baseline["files"], str(tmp_path / "ck"), *extra),
        on_step=on_step)
    assert (tmp_path / "ck" / "aasist_vocoded_0.pt").is_file()
    got = state.model.state_dict()
    assert steps == cli_baseline["losses"]
    for k, v in cli_baseline["state_dict"].items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("extra", [
    ["--grad_accum", "2", "--groups_per_step", "2"],
    ["--resume"],
    ["--lr_schedule", "cosine", "--warmup_steps", "1", "--decay_steps",
     "10"],
    ["--steps_per_dispatch", "2"],
    ["--checkpoint_every_steps", "5"],
    ["--rawboost_algo", "5"],
    ["--pretrained_xlsr", "xlsr2_tiny.pt"],
    ["--pretrained_xlsr", "xlsr2_tiny.pt", "--model", "ssl_resnet34"],
    ["--model", "ssl_resnet34"],
    ["--model", "ssl_lcnn"],
    ["--model", "ssl_lcnn_asoftmax"],
    ["--model", "cnn"],
    ["--model", "occm"],
    ["--grad_accum", "2", "--groups_per_step", "2", "--rawboost_algo", "5",
     "--model", "ssl_lcnn_asoftmax"],
    ["--grad_accum", "2", "--groups_per_step", "2", "--model", "occm"],
], ids=lambda e: e[0].lstrip("-") + "".join(
    f"-{v}" for k, v in zip(e, e[1:]) if k == "--model"))
def test_cli_ported_training_flags(tmp_path, monkeypatch, extra):
    """The training flags the port took over from the JAX package train on
    the CPU through the CLI, and the run writes a checkpoint that loads
    strictly (--resume continues a first epoch's checkpoint into a second
    epoch; --checkpoint_every_steps also leaves its step checkpoint;
    --rawboost_algo 5 trains other weights than the same run without it;
    --pretrained_xlsr grafts a fairseq-style checkpoint into the SSL
    frontend, over --init_from; --model trains each of the other models
    with its output kind's loss, into <model>_vocoded_<e>.pt, also under
    --grad_accum and with RawBoost)."""
    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.models import load_reference_state_dict

    protocol, train_dir, voc_dir = write_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    ck = tmp_path / "ck"
    name = extra[extra.index("--model") + 1] if "--model" in extra \
        else "aasist"
    if extra[0] == "--pretrained_xlsr":
        encoder = _tiny_encoder()
        with torch.no_grad():  # other weights than the CLI's seed-0 model
            for p in encoder.parameters():
                p.mul_(1.5)
        torch.save({"model": {"w2v_model." + k: v for k, v
                              in encoder.state_dict().items()},
                    "cfg": {"model": {"dropout": 0.1}}},
                   tmp_path / extra[1])
        grafted = oc_training.main(_cli_args(
            protocol, train_dir, voc_dir, str(tmp_path / "ck0"), *extra,
            "--init_from", "ignored.pt", "--num_epochs", "0"))
        scope = "ssl_model" if name == "aasist" else "frontend"
        got = getattr(grafted.model, scope).model.state_dict()
        for k, v in encoder.state_dict().items():
            torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-6)
    steps = []
    epochs = ["--num_epochs", "1"]
    if extra == ["--resume"]:
        oc_training.main(_cli_args(protocol, train_dir, voc_dir, str(ck)))
        epochs = ["--num_epochs", "2"]
    state = oc_training.main(
        _cli_args(protocol, train_dir, voc_dir, str(ck), *extra, *epochs),
        on_step=lambda step, m: steps.append((step, float(m["loss"]))))
    assert steps and all(np.isfinite(loss) for _, loss in steps)
    want_steps = {"grad_accum": 3, "resume": 12}.get(extra[0][2:], 6)
    assert state.step == want_steps == steps[-1][0]
    saved = sorted(p.name for p in ck.iterdir())
    last = f"{name}_vocoded_{1 if extra == ['--resume'] else 0}.pt"
    assert last in saved
    if extra[0] == "--checkpoint_every_steps":
        assert "aasist_vocoded_step_5.pt" in saved
    model, kind = oc_training.make_model(name, XLSRConfig.tiny())
    assert kind == state.output_kind == oc_training.OUTPUT_KIND_OF[name]
    model.load_state_dict(load_reference_state_dict(str(ck / last)),
                          strict=True)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    if extra[0] == "--rawboost_algo":
        plain = oc_training.main(
            _cli_args(protocol, train_dir, voc_dir, str(tmp_path / "ck0"),
                      *epochs))
        assert not torch.equal(
            plain.model.state_dict()["ssl_model.model.layer_norm.weight"],
            state.model.state_dict()["ssl_model.model.layer_norm.weight"])


# ---------------------------------------------------------------- configs

def test_train_configs_match_jax_defaults():
    for port, ref in ((TrainConfig(), JTrainConfig()),
                      (MeshConfig(), JMeshConfig()),
                      (RawBoostConfig(), JRawBoostConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
