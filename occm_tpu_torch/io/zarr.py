"""zarr v2 arrays over an OCDBT store (`io.ocdbt`), as orbax keeps each
leaf of a checkpoint of the JAX package.

An array `name` is the key `name/.zarray` (JSON: shape, chunks, dtype,
compressor, filters, order, fill_value, dimension_separator) and one key
per chunk, `name/<chunk indices joined by the separator>` (a 0-d array has
the one chunk "0"). A chunk holds the whole chunk shape, also at the array's
edges, in C order, compressed as the compressor says. orbax writes an
unsharded leaf as one chunk and a sharded one as a chunk per shard, all
zstd. `read_array` assembles the chunks; fp32, int32, int64 and the other
numpy dtypes come back as numpy arrays, bfloat16 (which numpy lacks) as a
`torch.bfloat16` tensor. A missing chunk, a filter, an order other than C
or a compressor other than zstd or none raises. `encode_array` writes one
chunk, zstd level 1, as orbax writes an unsharded leaf.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Dict, Tuple, Union

import numpy as np
import torch

from occm_tpu_torch.io import zstd
from occm_tpu_torch.io.ocdbt import OcdbtStore

BFLOAT16 = "bfloat16"
CHUNK_ZSTD_LEVEL = 1

Array = Union[np.ndarray, torch.Tensor]


def _dtype(meta: Dict, what: str) -> np.dtype:
    """The numpy dtype a chunk's bytes are in (uint16 for bfloat16)."""
    name = meta["dtype"]
    if name == BFLOAT16:
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"{what}: dtype {name!r} is not read") from e
    if dt.kind not in "biuf":
        raise ValueError(f"{what}: dtype {name!r} is not read")
    return dt


def read_meta(store: OcdbtStore, name: str) -> Dict:
    """The parsed `.zarray` of the array `name`."""
    key = f"{name}/.zarray"
    if key not in store:
        raise KeyError(f"{store.root}:{name}: no .zarray")
    return json.loads(store.read(key).tobytes())


def nbytes(meta: Dict) -> int:
    """The decoded size of the array that `meta` describes."""
    return math.prod(meta["shape"]) * _dtype(meta, "").itemsize


def read_array(store: OcdbtStore, name: str, meta: Dict = None) -> Array:
    """The zarr v2 array `name` of the store, whole (`meta`: its parsed
    `.zarray`, where the caller has read it)."""
    what = f"{store.root}:{name}"
    if meta is None:
        meta = read_meta(store, name)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ValueError(f"{what}: filters {meta['filters']} are not read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{what}: order {meta['order']!r} is not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {comp.get('id')!r} is not "
                         "read (zstd or none)")
    dt = _dtype(meta, what)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"]) or ()
    sep = meta.get("dimension_separator", ".")
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{what}: chunks {chunks} for shape {shape}")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]

    def chunk(idx: Tuple[int, ...], out: np.ndarray) -> None:
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if ckey not in store:
            raise ValueError(f"{what}: chunk {ckey!r} is missing")
        raw = store.read(ckey)
        if comp is None:
            if raw.size != out.nbytes:
                raise ValueError(f"{what}: chunk {ckey!r} holds {raw.size} "
                                 f"bytes, {out.nbytes} expected")
            out.reshape(-1).view(np.uint8)[:] = raw
        else:
            zstd.decompress_into(raw, out)

    if list(chunks) == list(shape):  # one chunk: decode in place
        out = np.empty(shape, dt)
        chunk(tuple(0 for _ in shape), out)
    else:
        out = np.empty(shape, dt)
        buf = np.empty(chunks, dt)
        for idx in itertools.product(*(range(g) for g in grid)):
            chunk(idx, buf)
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(idx, chunks, shape))
            out[region] = buf[tuple(slice(0, r.stop - r.start)
                                    for r in region)]
    if dt.byteorder == ">":
        out = out.astype(dt.newbyteorder("="))
    if meta["dtype"] == BFLOAT16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def encode_array(value: Array) -> Tuple[bytes, bytes]:
    """(.zarray JSON, the one chunk) of an array: zstd level 1, as orbax
    writes an unsharded leaf. Takes numpy arrays and CPU tensors,
    bfloat16 included."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, dtype = t.view(torch.int16).numpy().view("<u2"), BFLOAT16
        else:
            arr = t.numpy()
            dtype = None
    else:
        arr, dtype = np.asarray(value, order="C"), None
        if arr.dtype.name == BFLOAT16:  # ml_dtypes' bfloat16 (jax arrays)
            arr, dtype = arr.view("<u2"), BFLOAT16
    if dtype is None:
        if arr.dtype.kind not in "biuf":
            raise ValueError(f"dtype {arr.dtype} is not written")
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        dtype = arr.dtype.str
    meta = {"chunks": list(arr.shape),
            "compressor": {"id": "zstd", "level": CHUNK_ZSTD_LEVEL},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape),
            "zarr_format": 2}
    return (json.dumps(meta, separators=(",", ":")).encode(),
            zstd.compress(np.asarray(arr, order="C"), CHUNK_ZSTD_LEVEL))


def chunk_key(name: str, ndim: int) -> str:
    """The key of the one chunk `encode_array` writes."""
    return f"{name}/{'.'.join('0' * ndim) if ndim else '0'}"
