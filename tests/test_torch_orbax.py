"""The port's orbax IO (`occm_tpu_torch.io.zstd`, `.io.ocdbt`, `.io.zarr`,
`occm_tpu_torch.train.orbax`) against orbax itself.

The JAX package writes with its own functions (`save_params`,
`save_checkpoint` over a TrainState with optax adam's state and a step,
`save_step_checkpoint` with its progress, and the two converters) on
Flax variables fabricated from seeded numpy at `XLSRConfig.tiny()`
widths; `restore_tree` must give what `ocp.StandardCheckpointer().restore`
gives without a template, in structure and bit for bit. Also: a bfloat16
and 0-d leaves, a leaf sharded over 4 of the suite's 8 CPU devices (a
chunk per shard), a tree of 3000 leaves, tensorstore's own OCDBT trees
with interior nodes and zarr arrays with edge chunks, and the refusals
(a bad CRC, a truncated file, an unknown format field, use_zarr3, a
missing chunk, a missing libzstd). The other way, orbax restores
`save_tree`'s directories bit for bit, without a template and with one
(the JAX package's `restore_params`).
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.train import checkpoint as jckpt
from occm_tpu.train.state import TrainState
from occm_tpu_torch.io import ocdbt, zarr, zstd
from occm_tpu_torch.train import orbax
from test_torch_models import fabricated, perturbed

CUT = 3200


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch ops run on one thread (the suite's workers share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same(want, got, path="tree"):
    """`got` (restore_tree's) is orbax's `want`: the same dicts, lists and
    None, Python scalars of the same type, arrays of the same dtype, shape
    and bytes (a bfloat16 torch tensor against a JAX bfloat16 array)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{path}/{i}")
    elif want is None or isinstance(want, tuple):
        assert got == want and type(got) is type(want), path
    elif isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, path
    else:
        w = np.asarray(want)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            g = got.view(torch.int16).numpy()
            w = w.view(np.int16)
        else:
            g = got
            assert isinstance(g, np.ndarray), (path, type(g))
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                          w.dtype)
        assert g.tobytes() == w.tobytes(), path


def orbax_restore(path, template=None):
    ckptr = ocp.StandardCheckpointer()
    if template is None:
        return ckptr.restore(os.path.abspath(path))
    return ckptr.restore(os.path.abspath(path), template)


@pytest.fixture(scope="module")
def variables():
    model = JAModel(JAASISTConfig(), xlsr_cfg=JXLSRConfig.tiny())
    return perturbed(fabricated(model, np.zeros((2, CUT), np.float32)))


def _train_state(variables, seed=1):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    adam = optax.adam(1e-3)
    state = adam.init(params)

    def moment(x):
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))

    state = (state[0]._replace(count=jnp.asarray(7, jnp.int32),
                               mu=jax.tree_util.tree_map(moment, params),
                               nu=jax.tree_util.tree_map(moment, params)),
             ) + tuple(state[1:])
    return TrainState(step=jnp.asarray(7, jnp.int32), params=params,
                      batch_stats=variables["batch_stats"],
                      opt_state=state, tx=adam, apply_fn=None)


def test_reads_the_jax_packages_saves(variables, tmp_path):
    """save_params, save_checkpoint (optax adam's state comes back as
    [{count, mu, nu}, None]) and save_step_checkpoint (its progress)."""
    jckpt.save_params(variables["params"], str(tmp_path / "params"))
    state = _train_state(variables)
    epoch = jckpt.save_checkpoint(state, str(tmp_path), "aasist_vocoded", 3)
    step = jckpt.save_step_checkpoint(
        state, str(tmp_path), "aasist_vocoded",
        {"epoch": 3, "dispatches": 5, "opt_steps": 7, "running_loss": 1.5,
         "running_closs": 0.25, "running_dloss": 1.25})
    for path in (str(tmp_path / "params"), epoch, step):
        want = orbax_restore(path)
        got = orbax.restore_tree(path)
        assert_same(want, got)
    assert isinstance(got["opt_state"], list) and got["opt_state"][1] is None
    assert set(got["opt_state"][0]) == {"count", "mu", "nu"}
    assert got["step"].shape == () and got["step"].dtype == np.int32
    assert got["progress"]["dispatches"] == np.int32(5)
    assert orbax.is_orbax_dir(epoch) and not orbax.is_orbax_dir(
        str(tmp_path))


def test_reads_the_jax_converters_directories(tmp_path):
    from occm_tpu.models.convert_backend import convert_model_file
    from occm_tpu.models.convert_xlsr import convert_checkpoint_file
    from test_torch_convert_xlsr import _tiny_fairseq_sd

    torch.save({"model": _tiny_fairseq_sd(seed=3)}, tmp_path / "xlsr.pt")
    convert_checkpoint_file(str(tmp_path / "xlsr.pt"), str(tmp_path / "x"),
                            cfg=JXLSRConfig.tiny())
    torch.save({f"model.{k}": v for k, v in
                _tiny_fairseq_sd(seed=5).items()
                if not k.startswith(("mask_emb", "quantizer", "project_q",
                                     "final_proj"))},
               tmp_path / "ssl_vocoded_0.pt")
    assert convert_model_file(str(tmp_path / "ssl_vocoded_0.pt"),
                              str(tmp_path / "m"),
                              xlsr_cfg=JXLSRConfig.tiny()) == "ssl"
    for name in ("x", "m"):
        assert_same(orbax_restore(tmp_path / name),
                    orbax.restore_tree(str(tmp_path / name)))
    assert orbax.restore_tree(str(tmp_path / "m"))["batch_stats"] == {}


def test_bfloat16_scalars_and_empty_values(tmp_path):
    rng = np.random.default_rng(2)
    tree = {"bf16": jnp.asarray(rng.normal(size=(5, 3)), jnp.bfloat16),
            "bf16_0d": jnp.asarray(1.5, jnp.bfloat16),
            "f32_0d": np.float32(2.5), "i32_0d": jnp.asarray(-4, jnp.int32),
            "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "i8": rng.integers(-128, 127, (4, 4)).astype(np.int8),
            "py": {"int": 7, "float": 0.5}, "none": None, "empty": {},
            "seq": [np.ones(3, np.float32), [], ()]}
    jckpt.save_params(tree, str(tmp_path / "t"))
    got = orbax.restore_tree(str(tmp_path / "t"))
    assert_same(orbax_restore(tmp_path / "t"), got)
    assert got["bf16"].dtype == torch.bfloat16 and got["bf16_0d"].shape == ()


def test_sharded_leaf_reads_chunk_by_chunk(tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = np.array(jax.devices()[:4])
    rng = np.random.default_rng(3)
    tree = {
        "rows": jax.device_put(rng.normal(size=(12, 5)).astype(np.float32),
                               NamedSharding(Mesh(devices, ("x",)), P("x"))),
        "grid": jax.device_put(
            rng.normal(size=(8, 6)).astype(np.float32),
            NamedSharding(Mesh(devices.reshape(2, 2), ("a", "b")),
                          P("a", "b")))}
    jckpt.save_params(tree, str(tmp_path / "s"))
    store = ocdbt.OcdbtStore(str(tmp_path / "s"))
    assert sorted(k for k in store.keys() if k.startswith("rows/")) == [
        "rows/.zarray", "rows/0.0", "rows/1.0", "rows/2.0", "rows/3.0"]
    assert len([k for k in store.keys() if k.startswith("grid/")]) == 5
    assert_same(orbax_restore(tmp_path / "s"),
                orbax.restore_tree(str(tmp_path / "s")))


def test_tensorstore_interior_nodes_and_edge_chunks(tmp_path):
    """OCDBT trees of height > 0 (tensorstore with 600-byte nodes) and zarr
    arrays whose edge chunks overhang the shape, uncompressed and zstd,
    written by tensorstore itself."""
    import tensorstore as ts

    rng = np.random.default_rng(4)
    root = tmp_path / "db"
    spec = ts.KvStore.Spec(f"file://{root}/|ocdbt:").to_json()
    spec["config"] = {"max_decoded_node_bytes": 600,
                      "max_inline_value_bytes": 50}
    kv = ts.KvStore.open(spec).result()
    want = {f"k{i:04d}/{'abc'[i % 3]}": rng.bytes(int(rng.integers(1, 200)))
            for i in range(300)}
    txn = ts.Transaction()
    for k, v in want.items():
        kv.with_transaction(txn)[k] = v
    txn.commit_async().result()
    heights = []
    real = ocdbt.OcdbtStore._node

    def spy(self, rel, offset, length, height, prefix):
        heights.append(height)
        return real(self, rel, offset, length, height, prefix)

    ocdbt.OcdbtStore._node = spy
    try:
        store = ocdbt.OcdbtStore(str(root))
    finally:
        ocdbt.OcdbtStore._node = real
    assert max(heights) >= 2
    assert {k: store.read(k).tobytes() for k in store.keys()} == want

    arrays = {"f": rng.normal(size=(10, 7)).astype(np.float32),
              "i": rng.integers(-9, 9, (5, 3, 4)).astype(np.int64)}
    for comp in (None, {"id": "zstd", "level": 3}):
        path = tmp_path / f"z{comp is None}"
        for name, a in arrays.items():
            spec = ts.Spec(f"file://{path}/|ocdbt:{name}/|zarr2:").to_json()
            spec["metadata"] = {"shape": list(a.shape),
                                "chunks": [4, 3] + [3] * (a.ndim - 2),
                                "dtype": a.dtype.str, "compressor": comp}
            ts.open(spec, create=True).result().write(a).result()
        store = ocdbt.OcdbtStore(str(path))
        for name, a in arrays.items():
            got = zarr.read_array(store, name)
            assert got.dtype == a.dtype and np.array_equal(got, a)


def test_three_thousand_leaves(tmp_path):
    rng = np.random.default_rng(5)
    tree = {f"layer_{i:04d}": {"w": rng.normal(size=(3,)).astype(np.float32),
                               "n": np.int32(i)} for i in range(1500)}
    jckpt.save_params(tree, str(tmp_path / "big"))
    got = orbax.restore_tree(str(tmp_path / "big"))
    assert_same(orbax_restore(tmp_path / "big"), got)
    orbax.save_tree(got, str(tmp_path / "back"))
    assert_same(orbax_restore(tmp_path / "back"), got)


def _reframe(path, edit):
    """Rewrites the framed file at `path`: edit(body) on its decompressed
    body, compressed again under a fresh CRC."""
    buf = open(path, "rb").read()
    body = zstd.decompress(buf[14:-4])
    with open(path, "wb") as f:
        f.write(ocdbt._frame(edit(body), struct.unpack(">I", buf[:4])[0]))


@pytest.fixture
def small_ckpt(tmp_path):
    tree = {"a": np.arange(600, dtype=np.float32), "b": np.float32(1.0)}
    path = tmp_path / "c"
    jckpt.save_params(tree, str(path))
    return path


@pytest.mark.parametrize("fault, match", [
    ("crc", "CRC32C mismatch"), ("truncated", "length field says"),
    ("magic", "bad magic number"), ("version", "unknown format version 1"),
    ("compression", "unknown compression 7"),
    ("manifest_kind", "unknown manifest kind 1"),
    ("zstd_field", "unknown zstd configuration field 2"),
    ("zarr3", "use_zarr3 is true"), ("chunk", "chunk 'a/0' is missing"),
    ("node_crc", "CRC32C mismatch")])
def test_refuses_corrupt_or_unknown_input(small_ckpt, fault, match):
    manifest = small_ckpt / "manifest.ocdbt"
    buf = bytearray(open(manifest, "rb").read())
    if fault == "crc":
        buf[-1] ^= 1
        manifest.write_bytes(bytes(buf))
    elif fault == "truncated":
        manifest.write_bytes(bytes(buf[:-3]))
    elif fault == "magic":
        manifest.write_bytes(b"\x0c\xdb\x20\xde" + bytes(buf[4:]))
    elif fault in ("version", "compression"):
        at = 12 if fault == "version" else 13
        buf[at] = 1 if fault == "version" else 7
        body = bytes(buf[:-4])
        manifest.write_bytes(body + struct.pack("<I", ocdbt.crc32c(body)))
    elif fault == "manifest_kind":
        _reframe(manifest, lambda b: b[:16] + b"\x01" + b[17:])
    elif fault == "zstd_field":
        # uuid, kind, two varints, arity, compression 1, level, 3 fields
        def edit(b):
            c = ocdbt._Cursor(b, "")
            c.take(16), c.varint(), c.varint(), c.varint(), c.u8()
            c.varint(), c.varint(), c.varint()
            return b[:c.pos] + b"\x05" + b[c.pos + 1:]
        _reframe(manifest, edit)
    elif fault == "zarr3":
        meta = json.loads((small_ckpt / "_METADATA").read_text())
        meta["use_zarr3"] = True
        (small_ckpt / "_METADATA").write_text(json.dumps(meta))
    elif fault == "chunk":
        tree = {"a": np.arange(600, dtype=np.float32), "b": np.float32(1)}
        w = ocdbt.OcdbtWriter(str(small_ckpt) + "_w")
        zarray, _ = zarr.encode_array(tree["a"])
        w.put("a/.zarray", zarray)
        w.close()
        shutil.rmtree(small_ckpt / "d")
        os.remove(manifest)
        for name in os.listdir(str(small_ckpt) + "_w"):
            shutil.move(os.path.join(str(small_ckpt) + "_w", name),
                        small_ckpt / name)
        meta = json.loads((small_ckpt / "_METADATA").read_text())
        meta["tree_metadata"].pop("('b',)")
        (small_ckpt / "_METADATA").write_text(json.dumps(meta))
    elif fault == "node_crc":  # the root node, in the root's d/
        node = sorted((small_ckpt / "d").iterdir())[0]
        nb = bytearray(node.read_bytes())
        nb[20] ^= 0xFF
        node.write_bytes(bytes(nb))
    with pytest.raises(ValueError, match=match):
        orbax.restore_tree(str(small_ckpt))


def test_missing_libzstd_raises_naming_it(monkeypatch, small_ckpt):
    import ctypes

    def no_library(name, *a, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(ctypes, "CDLL", no_library)
    with pytest.raises(OSError, match="libzstd.so.1"):
        orbax.restore_tree(str(small_ckpt))


def test_zstd_and_crc32c_against_their_libraries():
    import google_crc32c
    import zstandard

    rng = np.random.default_rng(6)
    data = rng.normal(size=5000).astype(np.float32).tobytes()
    for frame in (zstandard.ZstdCompressor(
            level=1, write_content_size=False).compress(data),
            zstd.compress(data, 1)):
        assert zstd.decompress(frame) == data
        out = np.empty(5000, np.float32)
        zstd.decompress_into(frame, out)
        assert out.tobytes() == data
        with pytest.raises(ValueError, match="truncated"):
            zstd.decompress(frame[:-7])
    assert zstandard.ZstdDecompressor().decompress(zstd.compress(data, 5)) \
        == data
    for n in (0, 1, 13, 1000):
        assert ocdbt.crc32c(data[:n]) == google_crc32c.value(data[:n])
    assert zstd.version().count(".") == 2


def test_orbax_restores_save_tree_with_and_without_a_template(variables,
                                                              tmp_path):
    state = _train_state(variables)
    tree = {"params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": variables["batch_stats"],
            "opt_state": [{"count": np.asarray(state.opt_state[0].count),
                           "mu": jax.tree_util.tree_map(
                               np.asarray, state.opt_state[0].mu),
                           "nu": jax.tree_util.tree_map(
                               np.asarray, state.opt_state[0].nu)}, None],
            "step": np.asarray(7, np.int32),
            "half": torch.arange(6, dtype=torch.float32).to(torch.bfloat16),
            "scalar": 3}
    path = orbax.save_tree(tree, str(tmp_path / "port"))
    got = orbax.restore_tree(path)
    assert_same(orbax_restore(path), got)
    # the same tree saved by orbax reads the same
    want_tree = dict(tree, half=jnp.arange(6, dtype=jnp.bfloat16))
    jckpt.save_params(want_tree, str(tmp_path / "jax"))
    assert_same(orbax_restore(tmp_path / "jax"), got)
    # with a template: the JAX package's restore_params, the template's
    # arrays as jax arrays (its Python scalars as they are)
    template = jax.tree_util.tree_map(
        lambda x: x if isinstance(x, (int, float)) else jnp.asarray(x),
        orbax_restore(path))
    restored = jckpt.restore_params(template, path)
    assert isinstance(restored["params"]["backend"]["LL"]["kernel"],
                      jax.Array)
    assert_same(orbax_restore(path), jax.tree_util.tree_map(
        lambda x: x if isinstance(x, (int, float)) else np.asarray(x),
        restored))
    # a save over an existing directory replaces it, as orbax's force=True
    orbax.save_tree({"x": np.ones(2, np.float32)}, path)
    assert set(orbax.restore_tree(path)) == {"x"}
    assert_same(orbax_restore(path), orbax.restore_tree(path))


def test_large_leaves_go_indirect_and_round_trip(tmp_path):
    """Leaves over the inline limit are indirect values in the data file,
    those of PARALLEL_BYTES or more coded on the thread pool."""
    rng = np.random.default_rng(7)
    tree = {"big": rng.normal(size=(300, 1024)).astype(np.float32),
            "mid": rng.normal(size=(700,)).astype(np.float32),
            "small": np.float32(3.0)}
    path = orbax.save_tree(tree, str(tmp_path / "t"))
    store = ocdbt.OcdbtStore(path)
    assert isinstance(store.entries["big/0.0"], ocdbt.Indirect)
    assert isinstance(store.entries["small/0"], bytes)
    assert_same(orbax_restore(path), orbax.restore_tree(path))
