"""The port's training slice (`occm_tpu_torch.losses`, `.data`, `.train`,
`.cli.oc_training`, train-mode `.models`) against the JAX package.

- losses and group_one_class_loss on the same numpy inputs (rtol 1e-6);
- the meta-batch data path yields byte-identical batches for one seed;
- one train step of a tiny AModel from bridged weights, every kernel's
  route on (flash attention, ln_impl="pallas", fused_adam; the JAX side's
  Pallas kernels in interpret mode, the port's plain versions), against
  JAX make_train_step, then a second step from the JAX state after step 1
  through optimizer_state_from_flax;
- the dropout sites, and the CLI on the CPU.

Step tolerances: the loss to 1e-5 relative (fp32, the same forward in
another summation order). Adam's first update is lr * g / (|g| + eps), so
parameters agree to 1e-6 where the two gradients agree in sign. Where the
gradient is zero up to float noise, Adam turns the noise into a full step
of either sign: the biases that feed a train-mode BatchNorm (which removes
their effect) and the key projection's bias (softmax ignores it) have
exactly zero gradient. Entries whose port gradient is below 1e-6 of the
largest are therefore only held to the 2 * lr + 1e-6 that one step can
move them; of the rest at most 0.1 % (near-zero gradients of either sign)
may differ by more than 1e-6. The positional conv
is excluded: JAX trains its folded kernel, the port (as fairseq) the
weight-norm pair (g, v), so their updates differ by construction. BatchNorm
running means agree to 1e-5; running variances within the bessel factor
n / (n - 1) of the update (torch keeps the unbiased batch variance, Flax
the biased one).
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
                      compactness_weight=0.1, descriptiveness_weight=0.9)
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
        if "pos_conv" in k or "num_batches_tracked" in k:
            continue
        if k.endswith("running_mean"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       err_msg=k)
        elif k.endswith("running_var"):
            # one momentum-0.1 update with the biased (Flax) or unbiased
            # (torch) batch variance: they differ by at most 0.1 * var *
            # 1 / (n - 1), n >= 12 here
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0.1 / 11,
                                       atol=1e-5, err_msg=k)
        else:
            diff = np.abs(g.numpy() - w.numpy())
            assert diff.max() <= 2 * LR + 1e-6, k
            if k in noise:  # bn1 never runs: no gradient, never updated
                diff = diff[~noise[k]]
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
    assert "ssl_model.model.encoder.pos_conv.0.weight_g" not in opt["mu"]
    state.load_optimizer_state(opt)
    x = torch.from_numpy(jax_steps["x"])
    labels = torch.from_numpy(jax_steps["labels"]).long()
    noise = _noise_masks(state, x, labels, cfg)
    metrics = train_step(state, x, labels, cfg)
    assert float(metrics["loss"]) == pytest.approx(jax_steps["loss2"],
                                                   rel=1e-5)
    assert state.optimizer.count == 2
    _assert_state_matches(state.model, jax_steps["s2"], noise)


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
    model = _tiny_encoder(layerdrop=1.0).train()
    model(_wave(3), generator=torch.Generator().manual_seed(0)) \
        .sum().backward()
    for layer in model.encoder.layers:
        assert all(p.grad is None for p in layer.parameters())


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


def test_cli_trains_on_the_cpu_and_writes_a_servable_checkpoint(
        tmp_path, monkeypatch):
    from occm_tpu_torch.cli import oc_server, oc_training

    protocol, train_dir, voc_dir = write_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    steps = []
    state = oc_training.main(
        _cli_args(protocol, train_dir, voc_dir, str(tmp_path / "ck")),
        on_step=lambda step, m: steps.append(float(m["loss"])))
    assert len(steps) == 6 and all(np.isfinite(steps))
    assert state.step == 6
    path = tmp_path / "ck" / "aasist_vocoded_0.pt"
    assert path.is_file()
    model = oc_server.build_model(XLSRConfig.tiny(), str(path),
                                  allow_random_init=False, device="cpu")
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 6 and saved["optimizer"]["count"] == 6
    # a warm start from the checkpoint
    state2 = oc_training.main(
        _cli_args(protocol, train_dir, voc_dir, str(tmp_path / "ck2"),
                  "--init_from", str(path), "--num_epochs", "0"))
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(state2.model.state_dict()[k], v, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("extra", [
    ["--grad_accum", "2", "--groups_per_step", "2"],
    ["--resume"],
    ["--lr_schedule", "cosine", "--decay_steps", "10"],
    ["--rawboost_algo", "3"],
    ["--model", "ssl_lcnn"],
    ["--pretrained_xlsr", "xlsr.pt"],
    ["--fsdp", "2"],
    ["--steps_per_dispatch", "2"],
    ["--checkpoint_every_steps", "5"],
    ["--fast_numerics"],
    ["--wandb_project", "p"],
    ["--pos_conv_impl", "s2d"],
], ids=lambda e: e[0].lstrip("-"))
def test_cli_unported_flags_raise(tmp_path, extra):
    from occm_tpu_torch.cli import oc_training

    with pytest.raises(NotImplementedError):
        oc_training.main(_cli_args("p.txt", "t", "v", str(tmp_path), *extra))


# ---------------------------------------------------------------- configs

def test_train_configs_match_jax_defaults():
    for port, ref in ((TrainConfig(), JTrainConfig()),
                      (MeshConfig(), JMeshConfig()),
                      (RawBoostConfig(), JRawBoostConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_train_rejects_rawboost():
    from occm_tpu_torch.train import train

    with pytest.raises(NotImplementedError, match="RawBoost"):
        train(torch.nn.Linear(1, 1), None, TrainConfig(), device="cpu")
