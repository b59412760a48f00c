"""orbax checkpoint directories of the JAX package, read and written
without orbax (the port's counterpart of the orbax half of
`occm_tpu.train.checkpoint`).

Every save of the JAX package goes through `ocp.StandardCheckpointer`:
a trainer epoch or step directory, a bare parameter tree (`save_params`),
or a converter's {"params", "batch_stats"} (`occm-convert-xlsr`,
`occm-convert-model`). Such a directory holds:

- `_METADATA`: JSON; `tree_metadata` maps each tree path to its keys
  (`key_type` 2 a dict key, 1 a sequence index) and its value type
  ("jax.Array", "np.ndarray", "scalar", or an empty container: "None",
  "Dict", "List", "Tuple"), with `"use_ocdbt": true, "use_zarr3": false`;
- an OCDBT store (`io.ocdbt`): the root `manifest.ocdbt` and `d/`, and
  after a multi-process save the per-process stores it points into;
- per leaf, a zarr v2 array (`io.zarr`) named by the path joined with ".";
- `_CHECKPOINT_METADATA`, `_sharding` and `array_metadatas/`, which only
  orbax reads.

`restore_tree` gives what `ocp.StandardCheckpointer().restore(path)` gives
without a template: dicts and lists as the key types say (an optax adam
state comes back as `[{"count", "mu", "nu"}, None]`), arrays as numpy
(bfloat16 as a torch tensor), scalars as Python numbers, empty containers
and None as themselves. `save_tree` writes the files orbax needs to restore
a tree with a template and without one: `_METADATA`,
`_CHECKPOINT_METADATA` and the OCDBT store, each leaf one zstd chunk (as
orbax writes an unsharded leaf). `is_orbax_dir` is the one test callers
use to tell such a directory from a torch file.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from occm_tpu_torch.io import zarr
from occm_tpu_torch.io.ocdbt import OcdbtStore, OcdbtWriter

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2
ARRAY_TYPES = ("jax.Array", "np.ndarray")
SCALAR = "scalar"
#: orbax's empty-value type strings (a NamedTuple restores as None)
EMPTY = {"None": lambda: None, "NamedTuple": lambda: None,
         "Dict": dict, "List": list, "Tuple": tuple}
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
WORKERS = min(8, os.cpu_count() or 1)
PARALLEL_BYTES = 1 << 20


def is_orbax_dir(path: str) -> bool:
    """Whether `path` is an orbax checkpoint directory (its `_METADATA`
    is there)."""
    return os.path.isfile(os.path.join(path, METADATA))


def _metadata(path: str) -> Dict:
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path}: not an orbax checkpoint (no "
                                f"{METADATA})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{meta_path}: use_zarr3 is true; only zarr v2 "
                         "checkpoints are read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{meta_path}: use_ocdbt is false; only OCDBT "
                         "checkpoints are read")
    if not isinstance(meta.get("tree_metadata"), dict):
        raise ValueError(f"{meta_path}: no tree_metadata")
    return meta


class _Node:
    """A container being built: a dict, or a sequence (by index)."""

    def __init__(self, kind: int):
        self.kind, self.items = kind, {}

    def finish(self, what: str):
        items = {k: v.finish(what) if isinstance(v, _Node) else v
                 for k, v in self.items.items()}
        if self.kind == KEY_DICT:
            return items
        if sorted(items) != list(range(len(items))):
            raise ValueError(f"{what}: sequence indices {sorted(items)}")
        return [items[i] for i in range(len(items))]


def _build(entries: List[Tuple[List[Dict], Any]], what: str):
    """The nested tree of (key_metadata, value) entries: dict keys make a
    dict, sequence indices a list."""
    if not entries:
        return {}
    root = _Node(entries[0][0][0]["key_type"])
    for keys, value in entries:
        node = root
        for i, k in enumerate(keys):
            if k["key_type"] != node.kind:
                raise ValueError(f"{what}: key {k['key']!r} of key_type "
                                 f"{k['key_type']} under a container of "
                                 f"key_type {node.kind}")
            key = int(k["key"]) if node.kind == KEY_SEQUENCE else k["key"]
            if i == len(keys) - 1:
                if key in node.items:
                    raise ValueError(f"{what}: key {k['key']!r} twice")
                node.items[key] = value
                break
            child = node.items.get(key)
            if child is None:
                kind = keys[i + 1]["key_type"]
                if kind not in (KEY_SEQUENCE, KEY_DICT):
                    raise ValueError(f"{what}: unknown key_type {kind}")
                child = node.items[key] = _Node(kind)
            elif not isinstance(child, _Node):
                raise ValueError(f"{what}: key {k['key']!r} is a leaf and "
                                 "a container")
            node = child
    if root.kind not in (KEY_SEQUENCE, KEY_DICT):
        raise ValueError(f"{what}: unknown key_type {root.kind}")
    return root.finish(what)


def _run(fn, jobs, sizes) -> None:
    """fn over the jobs: those of PARALLEL_BYTES or more on a thread pool
    (zstd and file reads drop the GIL), the small ones on this thread."""
    big = [j for j, n in zip(jobs, sizes) if n >= PARALLEL_BYTES]
    for job, n in zip(jobs, sizes):
        if n < PARALLEL_BYTES:
            fn(job)
    if big:
        with ThreadPoolExecutor(min(WORKERS, len(big))) as pool:
            list(pool.map(fn, big))


def top_level_keys(path: str) -> List[str]:
    """The top-level keys of the orbax checkpoint at `path`, from its
    `_METADATA` alone (no array is read)."""
    meta = _metadata(os.path.abspath(path))
    return sorted({str(item["key_metadata"][0]["key"])
                   for item in meta["tree_metadata"].values()
                   if item["key_metadata"]})


def restore_tree(path: str, subtree: Optional[str] = None):
    """The tree of the orbax checkpoint at `path`, as orbax restores it
    without a template (see the module docstring). With `subtree`, only
    the tree under that top-level key (say "progress"), reading no other
    array; {} when there is none."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    store = OcdbtStore(path)
    entries, arrays = [], []
    for name, item in meta["tree_metadata"].items():
        keys = item["key_metadata"]
        if subtree is not None:
            if not keys or str(keys[0]["key"]) != subtree:
                continue
            if len(keys) == 1:
                raise ValueError(f"{path}: {subtree} is a leaf")
        vtype = item.get("value_metadata", {}).get("value_type")
        if vtype in EMPTY:
            entries.append((keys, EMPTY[vtype]()))
        elif vtype in ARRAY_TYPES or vtype == SCALAR:
            entries.append((keys, None))
            arrays.append((len(entries) - 1, ".".join(
                str(k["key"]) for k in keys), vtype))
        else:
            raise ValueError(f"{path}: leaf {name} has value_type "
                             f"{vtype!r}, which is not read")

    def load(job):
        i, param, vtype, meta = job
        value = zarr.read_array(store, param, meta)
        if vtype == SCALAR:
            if value.ndim != 0:
                raise ValueError(f"{path}: scalar {param} has shape "
                                 f"{tuple(value.shape)}")
            value = value.item()
        entries[i] = (entries[i][0], value)

    jobs = [(i, param, vtype, zarr.read_meta(store, param))
            for i, param, vtype in arrays]
    _run(load, jobs, [zarr.nbytes(job[3]) for job in jobs])
    tree = _build(entries, path)
    return tree.get(subtree, {}) if subtree is not None else tree


def _flatten(tree, prefix=()):
    """(path of (key, key_type), leaf) of a tree of dicts, lists, tuples
    and leaves, in orbax's order (dict keys sorted)."""
    if isinstance(tree, dict):
        if not tree:
            yield prefix, tree
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"dict key {k!r} is not a string")
            yield from _flatten(tree[k], prefix + ((k, KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            yield prefix, tree
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + ((str(i), KEY_SEQUENCE),))
    else:
        yield prefix, tree


def _value_type(leaf) -> str:
    if leaf is None:
        return "None"
    if isinstance(leaf, dict):
        return "Dict"
    if isinstance(leaf, list):
        return "List"
    if isinstance(leaf, tuple):
        return "Tuple"
    if isinstance(leaf, (bool, int, float)):
        return SCALAR
    if isinstance(leaf, (np.ndarray, np.generic, torch.Tensor)):
        return "np.ndarray"
    raise TypeError(f"leaf of type {type(leaf).__name__} is not written")


def save_tree(tree, path: str, array_type: str = "np.ndarray") -> str:
    """Write `tree` (nested dicts with string keys, lists and tuples; leaves
    numpy arrays or scalars, CPU or CUDA tensors, Python numbers, None) as
    an orbax checkpoint at `path`: the directory is written under a
    temporary name and renamed into place, replacing an old one (as the
    JAX package's saves do, with orbax's force=True). Array leaves are
    recorded as `array_type`: "np.ndarray" (a tree of numpy arrays saved
    by orbax) or "jax.Array" (of device arrays, as every leaf of the JAX
    package's trainer checkpoints is; orbax then records its
    `write_shape` too). Returns the absolute path."""
    if array_type not in ARRAY_TYPES:
        raise ValueError(f"array_type {array_type!r} (one of {ARRAY_TYPES})")
    path = os.path.abspath(path)
    started = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta, arrays = {}, []
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("the tree's root must be a dict or a sequence")
        vtype = _value_type(leaf)
        value_meta = {"value_type": vtype, "skip_deserialize": vtype in EMPTY}
        if vtype == "np.ndarray" and array_type == "jax.Array":
            value_meta = {"value_type": array_type,
                          "skip_deserialize": False,
                          "write_shape": [int(n) for n in (
                              leaf.shape if isinstance(leaf, torch.Tensor)
                              else np.shape(leaf))]}
        tree_meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value_meta}
        if vtype not in EMPTY:
            arrays.append((".".join(k for k, _ in keys), leaf))

    writer = OcdbtWriter(tmp)
    lock = threading.Lock()

    def encode(job):
        name, leaf = job
        zarray, chunk = zarr.encode_array(leaf)
        with lock:
            writer.put(f"{name}/.zarray", zarray)
            writer.put(zarr.chunk_key(name, np.ndim(leaf)), chunk)

    arrays = [(name, leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf)) for name, leaf in arrays]
    _run(encode, arrays,
         [leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
          else leaf.nbytes for _, leaf in arrays])
    writer.close()
    meta = {"tree_metadata": tree_meta, "use_ocdbt": True,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": started,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path
