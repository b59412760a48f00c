"""The port's GPipe pipeline (`XLSRConfig.pp_stages` / `pp_microbatches`,
`MeshConfig.pp`) and Megatron sequence parallelism (`seq_parallel`)
against the JAX package and against the port's own one-process step.

At tiny widths (`XLSRConfig.tiny()` at d_model 128 with four layers, so a
stage of two holds two), torch pinned to one thread:

- in one process, against JAX: the pipelined forward at S = 2 and
  M = 1, 2, 4 against `XLSREncoder` with the same fields and against the
  port's sequential forward (atol 2e-5, `tests/test_attention.py`'s); its
  gradients composed with remat (atol 5e-4 / rtol 1e-3, elementwise) and
  the bf16 mirror (the same, an entry also allowed 2 bf16 ulps of its
  summed microbatch terms, the gradients being bf16 sums; against JAX at
  most 2.5e-4 of the entries); JAX's ValueErrors; the pp placement
  tables on pp2 x tp2, pp2 x fsdp2 x tp2 and dp2 x pp2 x tp2 against
  JAX's specs on conftest's virtual devices; `seq_parallel` off a mesh
  and at tp = 1, bit for bit with the plain forward;
- over Gloo ranks (`tests/torch_mp_worker.py`, spawned once per module as
  one 2-rank and one 4-rank group): pp2, dp2 x pp2, pp2 x tp2,
  pp2 x fsdp2, tp2 + sp (at 159 and 160 frames) and dp2 x tp2 + sp
  against the one-process step on loss, parameters, Adam moments and the
  generator (`test_torch_parallel_train._assert_step`'s tolerances); two
  pp2 steps with every dropout site, layerdrop and RawBoost; pp2 with
  grad_accum, with remat and the mirror; pp2 against JAX's
  `make_train_step` on a dp1 x pp2 mesh (plain attention and FFN, no
  dropout; JAX's step takes about 20 s on one worker); the tp2 + sp
  forward against JAX's on a tp = 2 mesh; every remat policy under sp bit
  for bit with no remat; a pp2 checkpoint loaded strictly into one
  process and a one-process checkpoint resumed on pp2.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import MeshConfig as JMeshConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu.parallel import compute_mesh as j_compute_mesh
from occm_tpu.parallel import make_mesh as j_make_mesh
from occm_tpu.parallel import param_shardings as j_param_shardings
from occm_tpu_torch.config import AASISTConfig, MeshConfig, XLSRConfig
from occm_tpu_torch.models import (
    AModel, XLSREncoder, state_dict_from_flax, xlsr_state_dict_from_flax)
from occm_tpu_torch.parallel import compute_mesh, make_mesh, param_shardings
from occm_tpu_torch.train import train_step
from occm_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

import torch_mp_worker as W  # noqa: E402
import test_torch_parallel_train as P  # noqa: E402

L4 = dict(encoder_layers=4)
PP = dict(L4, pp_stages=2, pp_microbatches=2)
PP4 = dict(L4, pp_stages=2, pp_microbatches=4)
#: four stages of one layer on a pp = 2 mesh: each rank runs two
PP_S4 = dict(L4, pp_stages=4, pp_microbatches=4)
#: the JAX package's other attention layouts under tp = 2 (2 heads a rank)
TP_LAYOUTS = dict(L4, fused_qkv=True, attention_impl="packed")
SP = dict(L4, seq_parallel=True)
ADAM = dict(optimizer="adam")
FWD_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
#: the share of the mirrored gradients' entries that may exceed atol /
#: rtol (each by at most 2 bf16 ulps of its summed terms) against JAX's
#: pipeline (62 of the 474272 at the time of writing)
MIRROR_SHARE = 2.5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jxlsr(**fields):
    return dataclasses.replace(JXLSRConfig.tiny(), encoder_embed_dim=128,
                               **fields)


def _xlsr(**fields):
    return dataclasses.replace(XLSRConfig.tiny(), encoder_embed_dim=128,
                               **fields)


def _wave(rows, seed=0, cut=W.CUT):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, cut)) * 0.1).astype(np.float32)


def _encoder_variables(jcfg):
    """Flax encoder variables fabricated on the host (nothing compiled)."""
    model = JXLSREncoder(jcfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda x: model.init(key, x),
                            jnp.zeros((1, W.CUT)))
    rng = np.random.default_rng(1)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.05 * rng.standard_normal(s.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_encoder(cfg, variables):
    model = XLSREncoder(cfg)
    model.load_state_dict(xlsr_state_dict_from_flax(variables["params"],
                                                    cfg), strict=True)
    return model


# ------------------------------------------------ one process, against JAX

@pytest.mark.parametrize("m", [1, 2, 4])
def test_pipelined_forward_matches_jax_and_the_sequential_stack(m):
    fields = dict(L4, pp_stages=2, pp_microbatches=m)
    variables = _encoder_variables(_jxlsr(**L4))
    wave = _wave(4)
    want = np.asarray(JXLSREncoder(_jxlsr(**fields)).apply(
        variables, jnp.asarray(wave)))
    x = torch.from_numpy(wave)
    with torch.no_grad():
        got = _port_encoder(_xlsr(**fields), variables).eval()(x)
        seq = _port_encoder(_xlsr(**L4), variables).eval()(x)
    assert got.shape == want.shape == (4, 159, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=FWD_ATOL)
    # the same parameters as the sequential stack's
    assert list(XLSREncoder(_xlsr(**fields)).state_dict()) == list(
        XLSREncoder(_xlsr(**L4)).state_dict())


@pytest.mark.parametrize("mirror", [False, True], ids=["fp32", "mirror"])
def test_pipelined_gradients_match_jax_with_remat_and_the_mirror(mirror):
    """JAX's composition (tests/test_pipeline_pp.py:70-97): remat under
    attn_out_inner, with and without the bf16 parameter mirror; the
    gradients of sum(features^2), the port's pipelined against JAX's
    pipelined and against the port's sequential stack, elementwise at
    atol 5e-4 / rtol 1e-3. Under the mirror a layer weight's gradient is
    the bf16 gradient of its bf16 copy: each microbatch (JAX: each tick)
    adds its bf16 term, in another order on each side (the sequential
    stack rounds the whole batch's once), and where the terms cancel an
    entry keeps the terms' rounding, not its own. So there an entry may
    also exceed that bound by at most two bf16 roundings (2 ulps) of its
    summed terms |t_1| + ... + |t_M| (each t_m the sequential stack's
    gradient on microbatch m's rows); against JAX, which sums the same
    terms, at most MIRROR_SHARE of the model's entries may."""
    knobs = dict(L4, remat=True, remat_policy="attn_out_inner",
                 bf16_param_mirror=mirror)
    pp = dict(knobs, pp_stages=2, pp_microbatches=2)
    variables = _encoder_variables(_jxlsr(**knobs))
    wave = _wave(4, seed=3)
    jm = JXLSREncoder(_jxlsr(**pp))
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply(
        {"params": p}, jnp.asarray(wave), train=True) ** 2))(
        variables["params"])
    want = xlsr_state_dict_from_flax(jgrads, _xlsr(**pp))

    def grads(fields, rows=slice(None)):
        model = _port_encoder(_xlsr(**fields), variables).train()
        (model(torch.from_numpy(wave[rows])) ** 2).sum().backward()
        return {n: p.grad for n, p in model.named_parameters()}

    got, seq = grads(pp), grads(knobs)
    if mirror:
        terms = [grads(knobs, slice(m, m + 2)) for m in (0, 2)]
    over_jax = entries = 0
    for name, g in got.items():
        key = name + "_v" if name.endswith("pos_conv.0.weight") else name
        for against, ref in (("jax", want[key]), ("sequential", seq[name])):
            if not mirror:
                np.testing.assert_allclose(g.numpy(), ref.numpy(),
                                           atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                           err_msg=name)
                continue
            excess = (g - ref).abs() - GRAD_ATOL - GRAD_RTOL * ref.abs()
            summed = sum(t[name].abs() for t in terms)
            ulp = torch.exp2(torch.floor(torch.log2(
                summed.clamp_min(2.0 ** -126))) - 7)
            worst = float((excess / ulp).max())
            assert worst <= 2.0, (name, against, worst, "bf16 ulps")
            if against == "jax":
                over_jax += int((excess > 0).sum())
                entries += g.numel()
    assert over_jax <= MIRROR_SHARE * entries, (over_jax, entries)


def test_pipeline_invalid_configs_raise_as_jax():
    """tests/test_pipeline_pp.py:99-118 on both sides: S must divide the
    layers, M the rows, and sp with pp is refused at construction."""
    variables = _encoder_variables(_jxlsr())
    wave = _wave(4)
    for fields, match in ((dict(pp_stages=3), "divide encoder_layers"),
                          (dict(pp_stages=2, pp_microbatches=3),
                           "divide batch")):
        with pytest.raises(ValueError, match=match):
            JXLSREncoder(_jxlsr(**fields)).apply(variables,
                                                 jnp.asarray(wave))
        with pytest.raises(ValueError, match=match):
            _port_encoder(_xlsr(**fields), variables).eval()(
                torch.from_numpy(wave))
    with pytest.raises(ValueError, match="rows this rank"):
        _port_encoder(_xlsr(pp_stages=2, pp_microbatches=3),
                      variables).eval()(torch.from_numpy(wave))
    for make in (_jxlsr, _xlsr):
        with pytest.raises(ValueError, match="seq_parallel"):
            make(pp_stages=2, seq_parallel=True)


def _jax_layer_table(mesh_cfg, n_devices):
    """JAX's specs of the 4-layer model's stacked layer leaves, as the
    port's placements of each layer's leaf: name -> (tp_dim, fsdp_dim,
    stage)."""
    model = JAModel(JAASISTConfig.tiny(), xlsr_cfg=_jxlsr(**L4))
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda x: model.init(
        {"params": key, "dropout": key}, x), jnp.zeros((2, 3200)))["params"]
    jmesh = j_make_mesh(JMeshConfig(**mesh_cfg),
                        devices=jax.devices()[:n_devices])
    flat = jax.tree_util.tree_flatten_with_path(
        j_param_shardings(params, jmesh))[0]
    want = {}
    for path, sh in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        spec = tuple(sh.spec) + (None,) * 3
        if keys[:3] != ["ssl_model", "layers", "layer"]:
            assert "pp" not in spec, keys
            continue
        assert spec[0] == "pp", keys
        kernel = keys[-1] == "kernel"
        leaf = ".".join(keys[3:-1]) + (".weight" if kernel else ".bias"
                                        if keys[-1] == "bias" else ".weight")
        # [L, in, out] kernels are [out, in] weights; [L, n] vectors [n]
        to_dim = {2: 0, 1: 1} if kernel else {1: 0}
        dims = {a: to_dim[spec.index(a)] if a in spec else None
                for a in ("tp", "fsdp")}
        for layer in range(4):
            want[f"ssl_model.model.encoder.layers.{layer}.{leaf}"] = (
                dims["tp"], dims["fsdp"], layer // 2)
    return want


@pytest.mark.parametrize("mesh_cfg", [dict(dp=1, pp=2, tp=2),
                                      dict(dp=1, pp=2, fsdp=2, tp=2),
                                      dict(dp=2, pp=2, tp=2)], ids=str)
def test_pp_placement_is_jaxs_on_the_port_names(mesh_cfg):
    """Stage s owns layers 2s and 2s + 1 (JAX's "pp" on the stacked [L]
    axis), composed with the tp and fsdp rules; nothing else is
    stage-placed."""
    n = int(np.prod(list(mesh_cfg.values())))
    want = _jax_layer_table(mesh_cfg, n)
    named = list(AModel(AASISTConfig.tiny(), _xlsr(**L4)).named_parameters())
    table = param_shardings(named, make_mesh(MeshConfig(**mesh_cfg),
                                             world_size=n))
    got = {name: (pl.tp_dim, pl.fsdp_dim, pl.stage)
           for name, pl in table.items() if pl.stage is not None}
    assert got == want
    assert all(pl.stage is None for name, pl in table.items()
               if "encoder.layers." not in name)


def test_sequence_parallel_off_a_mesh_and_at_tp_1_changes_nothing():
    variables = _encoder_variables(_jxlsr())
    x = torch.from_numpy(_wave(2))
    with torch.no_grad():
        want = _port_encoder(_xlsr(), variables).eval()(x)
        sp = _port_encoder(_xlsr(seq_parallel=True), variables).eval()
        off = sp(x)
        with compute_mesh(make_mesh(MeshConfig(dp=1, tp=1), world_size=1)):
            tp1 = sp(x)
    assert torch.equal(off, want) and torch.equal(tp1, want)
    jwant = JXLSREncoder(_jxlsr(seq_parallel=True)).apply(
        variables, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(off.numpy(), np.asarray(jwant),
                               atol=FWD_ATOL)


def test_train_refuses_what_the_pipeline_does_not_run(tmp_path):
    """A mesh with pp > 1 trains a model whose pp_stages pp divides (each
    rank then runs pp_stages / pp stages: the rank case pp2s4 trains
    pp_stages 4 on pp 2), and not as a CUDA graph of k steps (ROADMAP
    queue A item 16)."""
    from occm_tpu_torch.train.loop import train

    mesh = make_mesh(MeshConfig(dp=1, pp=2), world_size=2, rank=0)
    for fields, train_kw, match in (
            (L4, {}, "pp=2 must divide pp_stages=1"),
            (PP, dict(steps_per_dispatch=2), "item 16")):
        x, a, t = W.configs("jax", fields, **train_kw)
        with pytest.raises(ValueError, match=match):
            train(AModel(a, x), W._Pipeline([], 0, 1), t, num_epochs=1,
                  device="cpu", mesh=mesh)


# ------------------------------------------------------------ over ranks

MESHES = {"pp2": dict(dp=1, pp=2), "tp2": dict(dp=1, tp=2),
          "dp2pp2": dict(dp=2, pp=2), "pp2tp2": dict(dp=1, pp=2, tp=2),
          "pp2fsdp2": dict(dp=1, pp=2, fsdp=2),
          "dp2tp2": dict(dp=2, tp=2)}
#: name -> (mesh, kind, xlsr fields, train fields, batch, steps)
STEPS = {
    "pp2-jax": ("pp2", "jax", PP, {}, "b", 1),
    "pp2-all": ("pp2", "all", PP4, {}, "b", 2),
    "pp2-accum": ("pp2", "kernels", PP, dict(grad_accum=2,
                                             groups_per_step=2), "b", 1),
    "pp2-remat": ("pp2", "remat", dict(PP, bf16_param_mirror=True), {},
                  "b", 1),
    "tp2-sp159": ("tp2", "dropout", SP, {}, "b", 1),
    "tp2-sp160": ("tp2", "dropout", SP, {}, "b160", 1),
    "dp2pp2": ("dp2pp2", "dropout", PP, {}, "b", 1),
    "pp2tp2": ("pp2tp2", "dropout", PP, {}, "b", 1),
    "pp2fsdp2": ("pp2fsdp2", "kernels", PP, {}, "b", 1),
    "dp2tp2-sp": ("dp2tp2", "dropout", SP, {}, "b", 1),
    "pp2s4": ("pp2", "jax", PP_S4, {}, "b", 1),
    "tp2-layouts": ("tp2", "jax", TP_LAYOUTS, {}, "b", 1),
}
#: the cases whose ranks run train() (over an unsharded pipeline) rather
#: than train_step
TRAIN_API = ("pp2s4",)


def _world(mesh):
    return int(np.prod(list(MESHES[mesh].values())))


def _single(init, kind, xlsr, train, batches, steps, state=None):
    """The port's one-process steps."""
    if state is None:
        state, _ = W.build_state(init, kind, xlsr, **train)
    t = W.configs(kind, xlsr, **train)[2]
    labels = torch.from_numpy(batches["labels"])
    losses = []
    for i in range(steps):
        x = batches["x"] if i == 0 else batches[f"x{i}"]
        losses.append(float(train_step(state, torch.from_numpy(x), labels,
                                       t)["loss"]))
    opt = state.optimizer_state()
    return {"losses": losses,
            "state_dict": {k: v.detach().clone()
                           for k, v in state.model.state_dict().items()},
            "mu": {k: v.clone() for k, v in opt["mu"].items()},
            "state": state}


def _jax_pp_step(variables, x, labels, fields=PP):
    """JAX's make_train_step on a dp1 x pp2 mesh of two virtual devices
    (the GPipe schedule of `_pp_stack`, the stacked layers stage-sharded;
    `fields` the pipeline's XLSRConfig fields)."""
    from occm_tpu.parallel import place_state_on_mesh as j_place
    from occm_tpu.parallel import shard_batch as j_shard_batch
    from occm_tpu.parallel import train_state_shardings as j_shardings
    from occm_tpu.train.loop import make_optimizer as j_make_optimizer
    from occm_tpu.train.loop import make_train_step
    from occm_tpu.train.state import TrainState as JTrainState

    jx, ja, cfg = P._jax_configs()
    jx = dataclasses.replace(jx, **fields)
    cfg = dataclasses.replace(cfg, mesh=JMeshConfig(dp=1, pp=2))
    model = JAModel(ja, xlsr_cfg=jx)
    mesh = j_make_mesh(cfg.mesh, devices=jax.devices()[:2])
    tx, _ = j_make_optimizer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree_util.tree_map(
                            jnp.asarray, variables["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=model.apply)
    step = make_train_step(cfg, state_shardings=j_shardings(state, mesh))
    state = j_place(state, mesh)
    with j_compute_mesh(mesh):
        batch = j_shard_batch((jnp.asarray(x),
                               jnp.asarray(labels.astype(np.int32))), mesh)
        state, metrics = step(state, batch, jax.random.PRNGKey(1))
    snap = jax.tree_util.tree_map(np.asarray, state)
    xcfg = W.configs("jax", fields)[0]
    from occm_tpu_torch.models.convert import optimizer_state_from_flax

    sd = state_dict_from_flax({"params": snap.params,
                               "batch_stats": snap.batch_stats}, xcfg)
    mu = optimizer_state_from_flax(snap.opt_state, xcfg)["mu"]
    return {"loss": float(metrics["loss"]), "state_dict": sd, "mu": mu}


def _jax_sp_forward(variables, wave):
    """JAX's tp = 2 forward with seq_parallel on two virtual devices."""
    from occm_tpu.parallel import batch_sharding as j_batch_sharding

    model = JXLSREncoder(_jxlsr(**SP))
    params = {"params": variables["params"]["ssl_model"]}
    mesh = j_make_mesh(JMeshConfig(dp=1, tp=2), devices=jax.devices()[:2])
    sh = j_param_shardings(params["params"], mesh)
    placed = jax.tree_util.tree_map(jax.device_put, dict(params["params"]),
                                    dict(sh))
    x = jax.device_put(jnp.asarray(wave), j_batch_sharding(mesh))
    with j_compute_mesh(mesh):
        return np.asarray(jax.jit(lambda p, x: model.apply(
            {"params": p}, x))(placed, x))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank case, the one-process references and JAX's steps."""
    out = str(tmp_path_factory.mktemp("pipeline"))
    jx, ja, _ = P._jax_configs()
    jmodel = JAModel(ja, xlsr_cfg=dataclasses.replace(jx, **L4))
    x, labels = P._batch(0)
    variables = P._fabricated(jmodel, x[:12])
    init = os.path.join(out, "init.pt")
    torch.save(state_dict_from_flax(variables, W.configs("jax", L4)[0]),
               init)
    batches = {"b": dict(x=x, labels=labels, x1=P._batch(1)[0]),
               "b160": dict(x=_wave(24, seed=2, cut=3220), labels=labels)}
    files = {}
    for key, arrays in batches.items():
        files[key] = os.path.join(out, f"{key}.npz")
        np.savez(files[key], **arrays)
    # a one-process checkpoint after one pp step, for the resume on pp2
    first = _single(init, "jax", PP, {}, batches["b"], 1)
    ckpt_one = os.path.join(out, "ckpt_one")
    save_checkpoint(first["state"], ckpt_one, "aasist_vocoded", 0)
    ckpt_pp = os.path.join(out, "ckpt_pp")

    def case(name, mesh, kind, xlsr, train, batch, steps, **kw):
        return dict(name=name, mesh=MESHES[mesh], kind=kind, xlsr=xlsr,
                    train=train, init=init, batch=files[batch], steps=steps,
                    **kw)

    cases = [case(n, *spec, train_api=n in TRAIN_API)
             for n, spec in STEPS.items()]
    cases[0]["save_dir"] = ckpt_pp
    cases += [case("pp2-restore", "pp2", "jax", PP, ADAM, "b", 1,
                   restore_dir=ckpt_one),
              case("tp2-sp-remat", "tp2", "dropout", SP, {}, "b", 1,
                   remat_policies=True),
              case("tp2-sp-forward", "tp2", "jax", SP, {}, "b", 1,
                   forward=True, rows=4),
              case("tp2-packed4", "tp2", "jax",
                   dict(L4, attention_impl="packed4"), {}, "b", 1,
                   forward=True, rows=2, expect_error=True)]
    two = [c for c in cases if int(np.prod(list(c["mesh"].values()))) == 2]
    four = [c for c in cases if c not in two]
    procs = P._launch(2, two, out) + P._launch(4, four, out)

    refs = {}
    for name, (_, kind, xlsr, train, batch, steps) in STEPS.items():
        key = (kind, str(xlsr), str(train), batch, steps)
        if key not in refs:
            refs[key] = _single(init, kind, xlsr, train, batches[batch],
                                steps)
    second = _single(init, "jax", PP, ADAM, batches["b"], 1,
                     state=_restored(init, ckpt_one, ADAM))
    jax_pp = _jax_pp_step(variables, x, labels)
    jax_pp_s4 = _jax_pp_step(variables, x, labels, PP_S4)
    jax_sp = _jax_sp_forward(variables, x[:4])
    P._wait(procs)
    got = {c["name"]: torch.load(os.path.join(out, c["name"] + ".pt"),
                                 weights_only=False) for c in cases}
    ref_of = {name: refs[(kind, str(xlsr), str(train), batch, steps)]
              for name, (_, kind, xlsr, train, batch, steps)
              in STEPS.items()}
    return dict(got=got, refs=ref_of, second=second, jax_pp=jax_pp,
                jax_pp_s4=jax_pp_s4, jax_sp=jax_sp, init=init,
                ckpt_pp=ckpt_pp)


def _restored(init, directory, train=None):
    state, _ = W.build_state(init, "jax", PP, **(train or {}))
    restore_checkpoint(state, directory, "aasist_vocoded", 0)
    return state


@pytest.mark.parametrize("name", list(STEPS))
def test_step_matches_the_one_process_step(runs, name):
    """Loss, parameters, Adam moments and the generator's state after the
    case's steps (every rank returns the step's metrics)."""
    got, want = runs["got"][name], runs["refs"][name]
    for r in got["ranks"]:
        np.testing.assert_allclose(r["all_losses"], want["losses"],
                                   rtol=1e-4)
    P._assert_step(got["state_dict"], got["opt"]["mu"], want["state_dict"],
                   want["mu"], name)
    assert torch.equal(got["rng"], want["state"].generator.get_state())


@pytest.mark.parametrize("name, key", [("pp2-jax", "jax_pp"),
                                       ("pp2s4", "jax_pp_s4")])
def test_pp2_step_matches_jax_on_a_dp1_pp2_mesh(runs, name, key):
    """pp2 at S = 2, and at S = 4 through train() (each rank two stages
    of one layer, JAX's [4, ...] stage buffer sharded two to a device):
    the loss (the forward) and the parameters and Adam moments after the
    step (the gradients) against JAX's step."""
    got, want = runs["got"][name], runs[key]
    assert got["ranks"][0]["losses"][0] == pytest.approx(want["loss"],
                                                         rel=1e-4)
    P._assert_step(got["state_dict"], got["opt"]["mu"], want["state_dict"],
                   want["mu"], f"{name} vs jax")


def test_pack_width_that_does_not_divide_a_ranks_heads_raises(runs):
    """tiny's 4 heads over tp = 2: packed4 does not divide a rank's 2, and
    the ValueError names both numbers."""
    for r in runs["got"]["tp2-packed4"]["ranks"]:
        assert "pack width 4" in r["error"], r["error"]
        assert "num_heads=2" in r["error"] and "tp=2" in r["error"]


def test_each_stage_holds_only_its_layers(runs):
    """pp2: stage s holds layers 2s and 2s + 1 and no tensor of the
    others' (parameters or moments); both hold the rest whole."""
    got = runs["got"]["pp2-jax"]
    for rank, r in enumerate(got["ranks"]):
        assert set(r["stages"].values()) == {0, 1}
        for name, shape in r["param_shapes"].items():
            stage = r["stages"].get(name)
            if stage is not None and stage != rank:
                assert shape == [0] == r["moment_shapes"][name], name
            else:
                assert 0 not in shape, name
    x, a, _ = W.configs("jax", PP)
    named = list(AModel(a, x).named_parameters())
    full = sum(p.numel() for _, p in named)
    layers = sum(p.numel() for n, p in named if "encoder.layers." in n)
    held = [r["bytes_after"]["params"] // 4 for r in got["ranks"]]
    assert held == [full - layers // 2] * 2, (held, full, layers)


def test_pp_checkpoint_loads_strictly_into_one_process(runs):
    """The pp2 step's checkpoint (gathered over the stages, written by rank
    0 in the one-GPU format) loads with strict=True and equals the ranks'
    gathered state bit for bit."""
    got = runs["got"]["pp2-jax"]
    state = _restored(runs["init"], runs["ckpt_pp"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, got["state_dict"][k]), k
    opt = state.optimizer_state()
    for k, v in opt["mu"].items():
        assert torch.equal(v, got["opt"]["mu"][k]), k
    assert state.step == 1
    assert torch.equal(state.generator.get_state(), got["rng"])


def test_one_process_checkpoint_resumes_on_pp2(runs):
    """A one-process checkpoint (fused_adam's moments) restored into a pp2
    state of torch Adam, the CLI's default, whose stages keep no state of
    each other's layers; then a step: the one-process second step."""
    got, want = runs["got"]["pp2-restore"], runs["second"]
    assert got["ranks"][0]["losses"][0] == pytest.approx(want["losses"][0],
                                                         rel=1e-4)
    assert got["opt"]["count"] == 2 and got["step"] == 2
    P._assert_step(got["state_dict"], got["opt"]["mu"], want["state_dict"],
                   want["mu"], "pp2 restore")


def test_sequence_parallel_forward_matches_jax_on_a_tp2_mesh(runs):
    got = np.asarray(runs["got"]["tp2-sp-forward"]["ranks"][0]["feats"],
                     np.float32)
    assert got.shape == (4, 159, 128)
    np.testing.assert_allclose(got, runs["jax_sp"], atol=FWD_ATOL)


def test_every_remat_policy_under_sequence_parallelism(runs):
    """Each policy's recompute reruns the frame gathers in the same order
    on every rank: features and gradients bit for bit with no remat."""
    for r in runs["got"]["tp2-sp-remat"]["ranks"]:
        assert set(r["remat"]) == {"nothing", "dots", "attn_out",
                                   "attn_out_inner", "attn_probs",
                                   "attn_all"}
        assert all(same == [True, True] for same in r["remat"].values()), \
            r["remat"]
