"""The OCDBT key-value store (tensorstore's "Optionally-Cooperative
Distributed B+Tree") that orbax checkpoints of the JAX package are written
in: a reader of the whole tree and a writer of one leaf node.

A database is a directory. Its `manifest.ocdbt` holds the configuration
and the newest versions; each version names its root B+tree node by a data
file (a path relative to the directory), an offset and a length. A node is
a leaf (height 0) of keys and values, or an interior node of keys and
child nodes. A value is inline in its leaf, or indirect: its raw bytes at
an offset of a data file. Manifests and nodes share one framing:

    magic   u32 big-endian: 0x0cdb3a2a (manifest) or 0x0cdb20de (node)
    length  u64 little-endian: the framed bytes, this header included
    version varint: 0
    compression varint: 0 none, 1 zstd (the rest of the body is a frame)
    body
    crc32c  u32 little-endian over everything before it

Integers are LEB128 varints; tables are stored column by column. The
reader checks the magic, the length and the CRC of every manifest and
node, and refuses (ValueError naming the field) a version, compression,
manifest kind or configuration field that it does not know. The writer
lays out what orbax's merged single-process checkpoints hold, in one
directory: `d/<hex>` data files (the indirect values, and the one leaf
node) and `manifest.ocdbt` with one version. Writes go to temporary names
and the manifest is renamed into place last.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

import numpy as np

from occm_tpu_torch.io import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
MANIFEST_SINGLE = 0
#: the configuration orbax opens its OCDBT stores with
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NODE_ZSTD_LEVEL = 0  # zstd's default level, tensorstore's default
_HEADER = 14  # magic, length, and the two one-byte varints
MANIFEST = "manifest.ocdbt"


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), as OCDBT frames its manifests and nodes."""
    c, table = 0xFFFFFFFF, _CRC_TABLE
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated body")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _unframe(buf: bytes, magic: int, what: str,
             max_size: int = MAX_DECODED_NODE_BYTES) -> bytes:
    """The checked, decompressed body of one framed manifest or node."""
    if len(buf) < _HEADER + 4:
        raise ValueError(f"{what}: truncated ({len(buf)} bytes)")
    got = struct.unpack(">I", buf[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: bad magic number {got:#010x} (expected "
                         f"{magic:#010x})")
    length = struct.unpack("<Q", buf[4:12])[0]
    if length != len(buf):
        raise ValueError(f"{what}: length field says {length} bytes, "
                         f"{len(buf)} are there")
    crc = struct.unpack("<I", buf[-4:])[0]
    if crc32c(buf[:-4]) != crc:
        raise ValueError(f"{what}: CRC32C mismatch")
    head = _Cursor(buf[12:-4], what)
    version = head.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"{what}: unknown format version {version}")
    compression = head.varint()
    body = buf[12 + head.pos:-4]
    if compression == COMPRESSION_ZSTD:
        return zstd.decompress(body, max_size=max_size)
    if compression != COMPRESSION_NONE:
        raise ValueError(f"{what}: unknown compression {compression}")
    return bytes(body)


def _frame(body: bytes, magic: int) -> bytes:
    payload = (_varint(FORMAT_VERSION) + _varint(COMPRESSION_ZSTD)
               + zstd.compress(body, NODE_ZSTD_LEVEL))
    head = struct.pack(">I", magic) + struct.pack(
        "<Q", 4 + 8 + len(payload) + 4)
    framed = head + payload
    return framed + struct.pack("<I", crc32c(framed))


def _read_file_table(c: _Cursor) -> List[str]:
    """A data-file table: the full paths (base path + relative path),
    relative to the database's directory."""
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    c.varints(n)  # base path lengths: how tensorstore splits each path
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: bad data-file table")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        path = prev.decode()
        if os.path.isabs(path) or ".." in path.split("/"):
            raise ValueError(f"{c.what}: data file {path!r} lies outside "
                             "the database")
        paths.append(path)
    return paths


def _file_table(paths: List[str]) -> bytes:
    out = [_varint(len(paths))]
    prev = b""
    prefixes, suffixes = [], []
    for p in paths:
        b = p.encode()
        k = 0
        while k < min(len(prev), len(b)) and prev[k] == b[k]:
            k += 1
        prefixes.append(k)
        suffixes.append(b[k:])
        prev = b
    out.append(_varints(prefixes[1:]))
    out.append(_varints(len(s) for s in suffixes))
    out.append(_varints(0 for _ in paths))
    out.extend(suffixes)
    return b"".join(out)


def _keys(c: _Cursor, n: int, interior: bool):
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    common = c.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: bad key prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class Indirect:
    """A value stored out of its node: `length` bytes at `offset` of the
    data file `path` (relative to the database's directory)."""
    path: str
    offset: int
    length: int


Value = Union[bytes, Indirect]


@dataclass(frozen=True)
class Config:
    uuid: bytes
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int
    zstd_level: int


class OcdbtStore:
    """Every key of the newest version of the database at `root`, read at
    construction (the manifest and all nodes; values stay on disk until
    `read`)."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, MANIFEST)
        with open(path, "rb") as f:
            body = _unframe(f.read(), MANIFEST_MAGIC, path)
        c = _Cursor(body, path)
        self.config = self._config(c)
        files = _read_file_table(c)
        n = c.varint()
        gen = c.varints(n)
        height = [c.u8() for _ in range(n)]
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        num_keys = c.varints(n)
        c.varints(n)  # num_tree_bytes
        c.varints(n)  # num_indirect_value_bytes
        c.take(8 * n)  # commit times, u64 little-endian
        self.generation = max(gen) if n else 0
        self.entries: Dict[str, Value] = {}
        if n == 0:
            return
        i = gen.index(self.generation)
        if num_keys[i] == 0:  # an empty tree
            return
        self._node(self._ref(files, file_id[i], path), offset[i],
                   length[i], height[i], b"")

    def _config(self, c: _Cursor) -> Config:
        uid = c.take(16)
        kind = c.varint()
        if kind != MANIFEST_SINGLE:
            raise ValueError(f"{c.what}: unknown manifest kind {kind} "
                             "(only a single manifest.ocdbt is read)")
        max_inline, max_node = c.varint(), c.varint()
        arity = c.u8()
        compression = c.varint()
        level = 0
        if compression == COMPRESSION_ZSTD:
            # the level, then three parameters that tensorstore writes as 0
            level = c.varint()
            for i in range(3):
                extra = c.varint()
                if extra:
                    raise ValueError(f"{c.what}: unknown zstd configuration "
                                     f"field {i + 1} = {extra}")
        elif compression != COMPRESSION_NONE:
            raise ValueError(f"{c.what}: unknown compression {compression}")
        return Config(uid, max_inline, max_node, arity, compression, level)

    @staticmethod
    def _ref(files: List[str], i: int, what: str) -> str:
        if i >= len(files):
            raise ValueError(f"{what}: data file id {i} out of range")
        return files[i]

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, rel), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{os.path.join(self.root, rel)}: truncated "
                             f"({len(data)} of {length} bytes at {offset})")
        return data

    def _node(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{os.path.join(self.root, rel)}@{offset}"
        body = _unframe(self._read(rel, offset, length), NODE_MAGIC, what,
                        self.config.max_decoded_node_bytes)
        c = _Cursor(body, what)
        got = c.u8()
        if got != height:
            raise ValueError(f"{what}: node height {got}, expected {height}")
        files = _read_file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, height > 0)
        if height > 0:
            fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # statistics: keys, tree bytes, value bytes
            for i in range(n):
                self._node(self._ref(files, fid[i], what), off[i], ln[i],
                           height - 1, prefix + keys[i][:common[i]])
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        bad = [k for k in kinds if k not in (0, 1)]
        if bad:
            raise ValueError(f"{what}: unknown value kind {bad[0]}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid = c.varints(len(indirect))
        off = c.varints(len(indirect))
        where = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if i in where:
                f, o = where[i]
                self.entries[key] = Indirect(self._ref(files, f, what), o,
                                             lengths[i])
            else:
                self.entries[key] = c.take(lengths[i])

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def keys(self):
        return self.entries.keys()

    def read(self, key: str) -> np.ndarray:
        """The bytes of one value, as a uint8 array (an indirect value read
        straight from its data file into it)."""
        v = self.entries[key]
        if not isinstance(v, Indirect):
            return np.frombuffer(v, np.uint8)
        out = np.empty(v.length, np.uint8)
        path = os.path.join(self.root, v.path)
        with open(path, "rb") as f:
            f.seek(v.offset)
            if f.readinto(memoryview(out)) != v.length:
                raise ValueError(f"{path}: truncated ({v.length} bytes at "
                                 f"{v.offset})")
        return out


class OcdbtWriter:
    """Writes a new database at `root` (which must not hold one): `put`
    each key once, then `close`. Values over the inline limit go to one
    data file as they come; the leaf node and the manifest are written by
    `close`."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        if os.path.exists(os.path.join(root, MANIFEST)):
            raise FileExistsError(f"{root} already holds an OCDBT database")
        self.values_rel = f"d/{uuid.uuid4().hex}"
        self._values = None
        self._offset = 0
        self.entries: Dict[bytes, Tuple[int, object]] = {}

    def put(self, key: str, value: bytes) -> None:
        k = key.encode()
        if k in self.entries:
            raise KeyError(f"key {key!r} written twice")
        if len(value) <= MAX_INLINE_VALUE_BYTES:
            self.entries[k] = (0, bytes(value))
            return
        if self._values is None:
            self._values = open(os.path.join(self.root, self.values_rel),
                                "wb")
        self._values.write(value)
        self.entries[k] = (1, (self._offset, len(value)))
        self._offset += len(value)

    def close(self) -> None:
        if self._values is not None:
            self._values.close()
        keys = sorted(self.entries)
        files = [self.values_rel] if self._values is not None else []
        body = [bytes([0]), _file_table(files), _varint(len(keys))]
        prefixes, prev = [], b""
        for k in keys:
            n = 0
            while n < min(len(prev), len(k)) and prev[n] == k[n]:
                n += 1
            prefixes.append(n)
            prev = k
        body.append(_varints(prefixes[1:]))
        body.append(_varints(len(k) - p for k, p in zip(keys, prefixes)))
        body.extend(k[p:] for k, p in zip(keys, prefixes))
        kinds = [self.entries[k][0] for k in keys]
        body.append(_varints(
            len(v) if kind == 0 else v[1]
            for kind, v in (self.entries[k] for k in keys)))
        body.append(_varints(kinds))
        indirect = [self.entries[k][1] for k in keys
                    if self.entries[k][0] == 1]
        body.append(_varints(0 for _ in indirect))
        body.append(_varints(off for off, _ in indirect))
        body.extend(self.entries[k][1] for k in keys
                    if self.entries[k][0] == 0)
        node = _frame(b"".join(body), NODE_MAGIC)
        node_rel = f"d/{uuid.uuid4().hex}"
        self._write(node_rel, node)
        manifest = [
            uuid.uuid4().bytes, _varint(MANIFEST_SINGLE),
            _varint(MAX_INLINE_VALUE_BYTES), _varint(MAX_DECODED_NODE_BYTES),
            bytes([VERSION_TREE_ARITY_LOG2]), _varint(COMPRESSION_ZSTD),
            _varints([NODE_ZSTD_LEVEL, 0, 0, 0]),
            _file_table([node_rel]),
            _varint(1),  # one version, generation 1, its root the leaf
            _varints([1]), bytes([0]), _varints([0, 0, len(node)]),
            _varints([len(keys), len(node), self._offset]),
            struct.pack("<Q", time.time_ns()),
            _varint(0),  # no version-tree nodes
        ]
        self._write(MANIFEST, _frame(b"".join(manifest), MANIFEST_MAGIC))

    def _write(self, rel: str, data: bytes) -> None:
        path = os.path.join(self.root, rel)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

