"""The port's parallelism layer (`occm_tpu_torch.parallel`) against the
JAX package's (`occm_tpu.parallel`), without process groups: the mesh
layout and its errors, the TP and FSDP placement tables on the port's
parameter names, the data shard of each rank, a rank's rows of a global
batch, the pipeline's sharded epoch, and the pp axis and the fields
ROADMAP item 15b ported. The multi-rank arithmetic is
tests/test_torch_parallel_train.py's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import MeshConfig as JMeshConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.data import MetaBatchPipeline as JMetaBatchPipeline
from occm_tpu.data import PFDataset as JPFDataset
from occm_tpu.models import AModel as JAModel
from occm_tpu.parallel import batch_sharding as j_batch_sharding
from occm_tpu.parallel import data_shard_for_process as j_data_shard
from occm_tpu.parallel import make_mesh as j_make_mesh
from occm_tpu.parallel import param_shardings as j_param_shardings
from occm_tpu_torch.config import (
    AASISTConfig, MeshConfig, XLSRConfig)
from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
from occm_tpu_torch.models import AModel
from occm_tpu_torch.models.xlsr import XLSREncoder
from occm_tpu_torch.parallel import (
    compute_mesh, data_axes, data_parallel_size, data_shard_for_process,
    data_spec, make_mesh, param_shardings)
from occm_tpu_torch.parallel.mesh import pp_peer
from occm_tpu_torch.parallel.sharding import (
    FSDP_MIN_SIZE, Placement, local_rows, shard_of)

MESH_CFGS = [dict(dp=-1), dict(dp=4, tp=2), dict(dp=2, fsdp=2, tp=2),
             dict(dp=-1, fsdp=4), dict(dp=1, fsdp=2, tp=4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cfg", MESH_CFGS, ids=str)
def test_make_mesh_lays_ranks_out_as_jax_lays_devices(cfg):
    got = make_mesh(MeshConfig(**cfg), world_size=8)
    want = j_make_mesh(JMeshConfig(**cfg), devices=jax.devices()[:8])
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids - ids.min())
    assert got.groups == {}  # no process group: nothing communicates
    assert data_axes(got) == tuple(
        a for a in ("dp", "fsdp") if want.shape[a] > 1)
    assert data_spec(got) == tuple(
        jax.sharding.PartitionSpec(*data_spec(got)))


@pytest.mark.parametrize("cfg", [dict(dp=3, tp=2), dict(dp=4, fsdp=3)],
                         ids=str)
def test_make_mesh_refuses_what_does_not_cover_the_world(cfg):
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        make_mesh(MeshConfig(**cfg), world_size=8)
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        j_make_mesh(JMeshConfig(**cfg), devices=jax.devices()[:8])


def test_pipeline_axis_and_sequence_parallel_name_item_15b():
    """What ROADMAP item 15b ported: MeshConfig pp lays ranks out as
    JAX's make_mesh lays devices, the stages of one pipeline are each
    other's peers and load the same data, pp_stages and seq_parallel
    construct, and seq_parallel with pp raises JAX's ValueError."""
    cfg = dict(dp=2, pp=2, tp=2)
    got = make_mesh(MeshConfig(**cfg), world_size=8)
    want = j_make_mesh(JMeshConfig(**cfg), devices=jax.devices()[:8])
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids - ids.min())
    for rank in range(8):
        c = got.coords(rank)
        peers = [pp_peer(got, s, rank) for s in range(2)]
        assert peers[c["pp"]] == rank
        assert {data_shard_for_process(got, p) for p in peers} == {
            data_shard_for_process(got, rank)}
    for field, value in (("pp_stages", 2), ("seq_parallel", True)):
        assert getattr(dataclasses.replace(XLSRConfig(), **{field: value}),
                       field) == value
    with pytest.raises(ValueError, match="seq_parallel"):
        XLSRConfig(pp_stages=2, seq_parallel=True)
    assert MeshConfig(dp=2, fsdp=2, tp=2).tp == 2


class _Device:
    def __init__(self, process_index):
        self.process_index = process_index


class _ProcessMesh:
    """A mesh of one device per process, as JAX's data_shard_for_process
    reads one: its axis names, shape and devices' process indices."""

    axis_names = ("dp", "pp", "fsdp", "tp")

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)
        self.devices = np.vectorize(_Device, otypes=[object])(mesh.ranks)


@pytest.mark.parametrize("cfg", [dict(dp=4), dict(dp=1, fsdp=2, tp=2),
                                 dict(dp=2, tp=2), dict(dp=1, tp=4),
                                 dict(dp=2, fsdp=2)], ids=str)
def test_data_shard_of_each_rank_is_jaxs_for_one_device_per_process(cfg):
    mesh = make_mesh(MeshConfig(**cfg), world_size=4)
    got = [data_shard_for_process(mesh, r) for r in range(4)]
    want = [j_data_shard(_ProcessMesh(mesh), r) for r in range(4)]
    assert got == want
    if cfg == dict(dp=1, fsdp=2, tp=2):
        # JAX's docstring: 4 hosts on fsdp=2 x tp=2 form 2 data shards of
        # 2 hosts each, which load identical data
        assert got == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert {c for _, c in got} == {data_parallel_size(mesh)}


def _jax_params():
    jx = dataclasses.replace(JXLSRConfig.tiny(), encoder_embed_dim=128)
    model = JAModel(JAASISTConfig.tiny(), xlsr_cfg=jx)
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda x: model.init(
        {"params": key, "dropout": key}, x), jnp.zeros((2, 3200)))["params"]


def _port_params():
    x = dataclasses.replace(XLSRConfig.tiny(), encoder_embed_dim=128)
    return list(AModel(AASISTConfig.tiny(), x).named_parameters())


def test_tp_table_is_jaxs_on_the_port_names():
    """JAX's rules on the stacked [L, in, out] kernels ([L, out] biases)
    are the port's on torch's [out, in] weights: a sharded output axis is
    dim 0, a sharded input axis dim 1, each of the L layers."""
    jmesh = j_make_mesh(JMeshConfig(dp=1, tp=2), devices=jax.devices()[:2])
    want = {}
    n_layers = XLSRConfig.tiny().encoder_layers
    flat = jax.tree_util.tree_flatten_with_path(
        j_param_shardings(_jax_params(), jmesh))[0]
    for path, sh in flat:
        spec = tuple(sh.spec)
        if "tp" not in spec:
            continue
        keys = [str(getattr(k, "key", k)) for k in path]
        assert keys[:3] == ["ssl_model", "layers", "layer"], keys
        leaf = ".".join(keys[3:-1]) + (".weight" if keys[-1] == "kernel"
                                        else ".bias")
        axis = spec.index("tp")
        dim = {2: 0, 1: 1}[axis] if keys[-1] == "kernel" else 0
        for layer in range(n_layers):
            want[f"ssl_model.model.encoder.layers.{layer}.{leaf}"] = dim
    assert len(want) == 10 * n_layers
    mesh = make_mesh(MeshConfig(dp=1, tp=2), world_size=2)
    table = param_shardings(_port_params(), mesh)
    got = {n: p.tp_dim for n, p in table.items() if p.sharded}
    assert got == want
    assert all(p.fsdp_dim is None for p in table.values())


@pytest.mark.parametrize("tp", [1, 2])
def test_fsdp_table_shards_every_large_leaf_on_its_largest_free_axis(tp):
    mesh = make_mesh(MeshConfig(dp=1, fsdp=2, tp=tp), world_size=2 * tp)
    named = _port_params()
    table = param_shardings(named, mesh)
    for name, p in named:
        pl = table[name]
        shape = tuple(p.shape)
        free = [i for i in range(len(shape))
                if i != pl.tp_dim and shape[i] % 2 == 0]
        if p.numel() < FSDP_MIN_SIZE or not free:
            assert pl.fsdp_dim is None, name
        else:
            best = max(free, key=lambda i: (shape[i], -i))
            assert pl.fsdp_dim == best, name
    # JAX shards the same share of the leaves it does not stack
    jmesh = j_make_mesh(JMeshConfig(dp=1, fsdp=2), devices=jax.devices()[:2])
    flat = jax.tree_util.tree_flatten_with_path(
        j_param_shardings(_jax_params(), jmesh))[0]
    backend = [sh for path, sh in flat
               if str(getattr(path[0], "key", "")) != "ssl_model"]
    j_sharded = sum("fsdp" in tuple(sh.spec) for sh in backend)
    p_sharded = sum(table[n].fsdp_dim is not None for n, _ in named
                    if not n.startswith("ssl_model."))
    if tp == 1:
        # a conv weight is [O, I, H, W] here and [H, W, I, O] in Flax; the
        # same leaves pass the size threshold and have an even axis
        assert p_sharded == j_sharded


def test_shards_reassemble_the_full_tensor():
    mesh = make_mesh(MeshConfig(dp=1, fsdp=2, tp=2), world_size=4)
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    pl = Placement(tp_dim=0, fsdp_dim=1, shape=(8, 12))
    shards = {r: shard_of(full, pl, mesh, r) for r in range(4)}
    for r, s in shards.items():
        assert s.shape == (4, 6) and s.is_contiguous()
    c = {r: mesh.coords(r) for r in range(4)}
    rows = [torch.cat([shards[r] for r in range(4)
                       if c[r]["tp"] == t], dim=1) for t in range(2)]
    torch.testing.assert_close(torch.cat(rows, dim=0), full, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [dict(dp=8), dict(dp=2, fsdp=4),
                                 dict(dp=4, tp=2)], ids=str)
def test_rank_rows_are_jaxs_device_shards(cfg):
    x = np.arange(16 * 10, dtype=np.float32).reshape(16, 10)
    jmesh = j_make_mesh(JMeshConfig(**cfg), devices=jax.devices()[:8])
    xs = jax.device_put(jnp.asarray(x), j_batch_sharding(jmesh))
    mesh = make_mesh(MeshConfig(**cfg), world_size=8)
    n = data_parallel_size(mesh)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for shard in xs.addressable_shards:
        rank = int(np.argwhere(ids.reshape(-1) == shard.device.id)[0][0])
        index, count = data_shard_for_process(mesh, rank)
        assert count == n
        np.testing.assert_array_equal(local_rows(x, index, count),
                                      np.asarray(shard.data))


def test_rank_rows_of_each_micro_batch():
    """With grad_accum = 2, a rank's rows are its part of each global
    micro-batch, in order."""
    x = np.arange(24)
    assert local_rows(x, 1, 2, accum=2).tolist() == \
        list(range(6, 12)) + list(range(18, 24))


def test_pipeline_shard_yields_the_jax_packages_batches(tmp_path):
    from test_torch_train import CUT, write_fixture

    protocol, train_dir, voc_dir = write_fixture(tmp_path, n_bona=7)
    jds = JPFDataset(protocol, train_dir, voc_dir, cut=CUT, seed=3)
    ds = PFDataset(protocol, train_dir, voc_dir, cut=CUT, seed=3)
    for index in (0, 1):
        want = list(JMetaBatchPipeline(jds, groups_per_step=2, seed=3,
                                       shard_index=index, shard_count=2)
                    .epoch(1))
        pipe = MetaBatchPipeline(ds, groups_per_step=2, seed=3,
                                 shard_index=index, shard_count=2)
        got = list(pipe.epoch(1))
        # 9 items truncated to 8, 4 per shard: two full steps of G = 2
        assert len(got) == len(want) == pipe.steps_per_epoch() == 2
        for (x, l), (jx, jl) in zip(got, want):
            assert x.tobytes() == np.asarray(jx, np.float32).tobytes()
            np.testing.assert_array_equal(l, jl)
    mesh = make_mesh(MeshConfig(dp=1, fsdp=2, tp=2), world_size=4, rank=2)
    pipe = MetaBatchPipeline(ds, groups_per_step=2, mesh=mesh)
    assert (pipe.shard_index, pipe.shard_count) == (1, 2)
    assert (MetaBatchPipeline(ds).shard_index,
            MetaBatchPipeline(ds).shard_count) == (0, 1)
    with pytest.raises(ValueError, match="shard_index"):
        MetaBatchPipeline(ds, shard_index=2, shard_count=2)


def test_int8_projections_have_no_tensor_parallel_split():
    cfg = dataclasses.replace(XLSRConfig.tiny(), quant_int8=True)
    enc = XLSREncoder(cfg).eval()
    with compute_mesh(make_mesh(MeshConfig(dp=1, tp=2), world_size=2)):
        with pytest.raises(ValueError, match="tensor-parallel"):
            enc(torch.zeros(1, 3200))

