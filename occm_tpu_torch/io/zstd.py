"""Zstandard through the system's `libzstd.so.1` (ctypes).

`decompress` takes one or more frames, with or without a content size in
their headers (tensorstore's streaming compressor, which writes the orbax
checkpoints of the JAX package, leaves it out), through the streaming
`ZSTD_DStream` API; `decompress_into` fills a caller's buffer of the
decoded size exactly, so a 400 MB chunk is decoded without a copy.
`compress` writes one frame at a given level. The library is loaded at the
first call; where it is missing, that call raises OSError naming it. There
is no fallback: nothing else in the port decodes zstd. ctypes drops the
GIL for the call, so threads decode chunks in parallel.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

LIBRARY = "libzstd.so.1"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        names = [LIBRARY]
        found = ctypes.util.find_library("zstd")
        if found and found != LIBRARY:
            names.append(found)
        errors = []
        for name in names:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(str(e))
        else:
            raise OSError(
                f"{LIBRARY} (the Zstandard library) could not be loaded: "
                f"{'; '.join(errors)}. The port reads and writes orbax "
                "checkpoints through it; install the system's libzstd "
                "package")
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        for name, res, args in (
                ("ZSTD_versionString", ctypes.c_char_p, []),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_compressBound", size_t, [size_t]),
                ("ZSTD_compress", size_t,
                 [vp, size_t, vp, size_t, ctypes.c_int]),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong,
                 [vp, size_t]),
                ("ZSTD_createDStream", vp, []),
                ("ZSTD_initDStream", size_t, [vp]),
                ("ZSTD_freeDStream", size_t, [vp]),
                ("ZSTD_decompressStream", size_t,
                 [vp, ctypes.POINTER(_OutBuffer),
                  ctypes.POINTER(_InBuffer)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


def version() -> str:
    """The loaded library's version, for example "1.5.4"."""
    return _load().ZSTD_versionString().decode()


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def _view(buf) -> np.ndarray:
    """A uint8 view of a bytes-like object or an array (no copy)."""
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8)
    return np.frombuffer(buf, np.uint8)


def _stream(src: np.ndarray, grow) -> int:
    """Runs the stream decoder over all of `src`. grow(pos) returns the
    output array to go on writing into, holding the first pos bytes
    written (the same one, or a larger copy); returns the bytes written."""
    lib = _load()
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "init")
        inb = _InBuffer(src.ctypes.data, src.size, 0)
        pos = 0
        while True:
            out = grow(pos)
            outb = _OutBuffer(out.ctypes.data, out.size, pos)
            before = inb.pos
            pending = _check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(outb), ctypes.byref(inb)), "decompress")
            if inb.pos == inb.size and pending == 0:
                return outb.pos
            if outb.pos == pos and inb.pos == before:  # no progress
                if outb.pos == outb.size:
                    raise ValueError("zstd: the frame decodes to more "
                                     f"than {outb.size} bytes")
                raise ValueError("zstd: truncated frame")
            pos = outb.pos
    finally:
        lib.ZSTD_freeDStream(ds)


def decompress_into(src, out: np.ndarray) -> None:
    """Decode the frames in `src` into `out` (a contiguous array), which
    they must fill exactly."""
    dst = _view(out)
    n = _stream(_view(src), lambda pos: dst)
    if n != dst.size:
        raise ValueError(f"zstd: decoded {n} bytes where {dst.size} were "
                         "expected")


def decompress(src, max_size: int = 1 << 40) -> bytes:
    """Decode the frames in `src`; the result may be at most max_size
    bytes."""
    s = _view(src)
    lib = _load()
    size = lib.ZSTD_getFrameContentSize(s.ctypes.data, s.size)
    cap = size if size < (1 << 62) else max(4 * s.size, 1 << 16)
    held = [np.empty(min(max(cap, 1), max_size), np.uint8)]

    def grow(pos):
        out = held[0]
        if pos < out.size or out.size >= max_size:
            return out
        bigger = np.empty(min(2 * out.size, max_size), np.uint8)
        bigger[:pos] = out[:pos]
        held[0] = bigger
        return bigger

    n = _stream(s, grow)
    return held[0][:n].tobytes()


def compress(src, level: int) -> bytes:
    """One zstd frame of `src` at `level` (content size in its header)."""
    lib = _load()
    s = _view(src)
    out = np.empty(lib.ZSTD_compressBound(s.size), np.uint8)
    n = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.size,
                                      s.ctypes.data, s.size, level),
               "compress")
    return out[:n].tobytes()
