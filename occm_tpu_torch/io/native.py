"""ctypes binding of the native IO library (the port's own copy of
`occm_tpu/io/native.py`): threaded C++ WAV/FLAC decode with repeat-pad or
crop straight into a batch buffer, header-only length probes, and a
streaming, seekable FLAC decoder.

The library is built by the port at first use: `native/wavio.cpp` and
`native/flacdec.cpp` compiled with the host's C++ compiler (`$CXX`, else
`g++`, else `c++`) and the flags of `native/Makefile` into
`occm_tpu_torch/build/libocmio_<hash>.so`. The hash covers the two
sources, the compiler, the flags and the host CPU (the flags hold
`-march=native`), so an edited source is rebuilt and a library built for
another CPU is never loaded. Concurrent first uses (test workers, say)
build under a file lock, each into a temporary name renamed into place, so
every process loads a complete library. `native/libocmio.so`, which
`make -C native` builds for the JAX package, is never loaded.

Without a compiler, or when the build fails, `available()` is False after
one warning naming the reason, and the callers (`io.wav.load_audio`,
`serve_http.decode_spooled_audio`, `BucketedEmbedder.embed_paths`,
`PFDataset.supports_native_batch`) decode in Python instead: the same
waves, host-bound. This is host decoding only; nothing here touches a
device.

`CALLS` counts the calls into the library by entry point, so a caller can
show that the native lane was taken.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import warnings
from typing import List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("wavio.cpp", "flacdec.cpp")
#: native/Makefile's CXXFLAGS and libraries
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra",
            "-march=native")
LIBS = ("-lpthread",)

#: calls into the library since the last reset, by entry point
CALLS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: why the library is unavailable ("" when it loaded)
unavailable_reason = ""


def reset_counts() -> None:
    with _count_lock:
        CALLS.clear()


def _count(name: str) -> None:
    with _count_lock:  # request threads of the server call concurrently
        CALLS[name] += 1


def compiler() -> Optional[str]:
    """The C++ compiler the build uses: $CXX, else g++, else c++."""
    for c in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    return None


def _host_cpu() -> bytes:
    """What -march=native compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = {}
    for line in lines:
        key = line.split(b":", 1)[0].strip()
        if key in (b"model name", b"flags", b"Features") and key not in keep:
            keep[key] = line
    return b"\n".join(keep.values()) or platform.machine().encode()


def library_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx, *CXXFLAGS, *LIBS)).encode())
    h.update(_host_cpu())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libocmio_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if the current sources are not built yet (under
    a file lock, into a temporary name renamed into place); returns its
    path. Raises RuntimeError without a compiler or when it fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, g++ or c++) on PATH")
    path = library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *CXXFLAGS, "-o", tmp,
               *(os.path.join(NATIVE_DIR, s) for s in SOURCES), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode})"
                               f":\n{proc.stderr[-2000:]}")
        os.replace(tmp, path)
    return path


def _declare(lib: ctypes.CDLL) -> None:
    f, i, i64, p = (ctypes.c_float, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_char_p)
    pf, pi, pi64 = (ctypes.POINTER(f), ctypes.POINTER(i),
                    ctypes.POINTER(i64))
    paths = ctypes.POINTER(ctypes.c_char_p)
    for name, res, args in (
            ("ocm_read_wav", i, [p, ctypes.POINTER(pf), pi64, pi]),
            ("ocm_read_wav_padded", i, [p, pf, i64, pi64, pi]),
            ("ocm_read_batch_padded", i, [paths, i, pf, i64, pi64, pi, i]),
            ("ocm_free", None, [pf]),
            ("ocm_set_flac_crc", None, [i]),
            ("ocm_flac_seek_points", i, [p, pi64, pi64, i]),
            ("ocm_read_flac_range", i, [p, i64, i64, pf, pi64, pi]),
            ("ocm_flac_open", ctypes.c_void_p, [p, pi, pi64]),
            ("ocm_flac_read", i64, [ctypes.c_void_p, pf, i64]),
            ("ocm_flac_close", None, [ctypes.c_void_p]),
            ("ocm_read_audio_range", i, [p, i64, i64, pf, pi64, pi]),
            ("ocm_audio_len", i, [p, pi64, pi]),
            ("ocm_audio_len_batch", i, [paths, i, pi64, pi, i])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, unavailable_reason
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                lib = ctypes.CDLL(build())
                _declare(lib)
                _lib = lib
            except (OSError, RuntimeError) as e:
                unavailable_reason = str(e)
                warnings.warn(
                    f"native IO library unavailable ({unavailable_reason}); "
                    "audio decodes in Python", RuntimeWarning, stacklevel=3)
            _tried = True
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded (built at the first
    call)."""
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"native IO library unavailable: {unavailable_reason}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _c_paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def native_read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV or FLAC file (by magic bytes) to float32 mono ->
    (wave, sample rate). Raises IOError on a decode error."""
    lib = _lib_or_raise()
    out = ctypes.POINTER(ctypes.c_float)()
    n, sr = ctypes.c_int64(), ctypes.c_int()
    rc = lib.ocm_read_wav(path.encode(), ctypes.byref(out), ctypes.byref(n),
                          ctypes.byref(sr))
    _count("read_wav")
    if rc != 0:
        raise IOError(f"ocm_read_wav({path}) failed rc={rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.ocm_free(out)
    return arr, sr.value


def native_read_batch_padded(paths: List[str], max_len: int,
                             n_threads: int = 4
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threaded batch decode, each row repeat-padded or cropped to max_len
    in the output buffer -> (waves [B, max_len] float32, valid lengths [B]
    int64, rates [B] int32)."""
    lib = _lib_or_raise()
    count = len(paths)
    out = np.empty((count, max_len), np.float32)
    valid = np.empty((count,), np.int64)
    srs = np.empty((count,), np.int32)
    rc = lib.ocm_read_batch_padded(_c_paths(paths), count, _fptr(out),
                                   max_len, _i64ptr(valid), _iptr(srs),
                                   n_threads)
    _count("read_batch_padded")
    if rc != 0:
        raise IOError(f"ocm_read_batch_padded failed rc={rc}")
    return out, valid, srs


def native_audio_len(path: str) -> Tuple[int, int]:
    """Header-only (sample count, sample rate) of a WAV/FLAC file. Raises
    when the headers do not carry the length (a FLAC whose STREAMINFO
    says 0 samples); callers decode instead."""
    lib = _lib_or_raise()
    n, sr = ctypes.c_int64(), ctypes.c_int()
    rc = lib.ocm_audio_len(path.encode(), ctypes.byref(n), ctypes.byref(sr))
    _count("audio_len")
    if rc != 0:
        raise IOError(f"ocm_audio_len({path}) failed rc={rc}")
    return n.value, sr.value


def native_audio_len_batch(paths: List[str], n_threads: int = 8
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded header-only length probe -> (lengths [B] int64, rates [B]
    int32); -1 marks a file whose length the headers do not give (or a
    missing file): the caller decodes those."""
    lib = _lib_or_raise()
    count = len(paths)
    lens = np.empty((count,), np.int64)
    srs = np.empty((count,), np.int32)
    if count:
        lib.ocm_audio_len_batch(_c_paths(paths), count, _i64ptr(lens),
                                _iptr(srs), n_threads)
        _count("audio_len_batch")
    return lens, srs


def set_flac_crc_verify(enable: bool) -> None:
    """CRC-8 / CRC-16 verification in the native FLAC decoder (on by
    default; the Python decoder always verifies)."""
    _lib_or_raise().ocm_set_flac_crc(1 if enable else 0)


def flac_seek_points(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A FLAC file's SEEKTABLE -> (samples [N], byte offsets [N] from the
    first audio frame); empty without a seektable."""
    lib = _lib_or_raise()
    cap = 4096
    while True:
        samples = np.empty((cap,), np.int64)
        offsets = np.empty((cap,), np.int64)
        n = lib.ocm_flac_seek_points(path.encode(), _i64ptr(samples),
                                     _i64ptr(offsets), cap)
        _count("flac_seek_points")
        if n < 0:
            raise IOError(f"ocm_flac_seek_points({path}) failed rc={n}")
        if n <= cap:
            return samples[:n].copy(), offsets[:n].copy()
        cap = n  # the C side writes at most cap points but returns all


def _read_range(fn, name: str, path: str, start: int, count: int
                ) -> Tuple[np.ndarray, int]:
    out = np.empty((count,), np.float32)
    got, sr = ctypes.c_int64(), ctypes.c_int()
    rc = fn(path.encode(), start, count, _fptr(out), ctypes.byref(got),
            ctypes.byref(sr))
    _count(name)
    if rc != 0:
        raise IOError(f"ocm_{name}({path}) failed rc={rc}")
    return out[: got.value].copy(), sr.value


def native_read_flac_range(path: str, start: int, count: int
                           ) -> Tuple[np.ndarray, int]:
    """Samples [start, start + count) of a FLAC file, seeking through the
    SEEKTABLE where there is one -> (float32 [<= count], sample rate)."""
    return _read_range(_lib_or_raise().ocm_read_flac_range,
                       "read_flac_range", path, start, count)


def native_read_audio_range(path: str, start: int, count: int
                            ) -> Tuple[np.ndarray, int]:
    """Samples [start, start + count) of a WAV or FLAC file ->
    (float32 [<= count], sample rate)."""
    return _read_range(_lib_or_raise().ocm_read_audio_range,
                       "read_audio_range", path, start, count)


class FlacStream:
    """Streaming FLAC reader over the native decoder: frame-at-a-time,
    constant decoder memory per read. A context manager."""

    def __init__(self, path: str):
        self._lib = _lib_or_raise()
        sr, total = ctypes.c_int(), ctypes.c_int64()
        self._h = self._lib.ocm_flac_open(path.encode(), ctypes.byref(sr),
                                          ctypes.byref(total))
        _count("flac_open")
        if not self._h:
            raise IOError(f"ocm_flac_open({path}) failed")
        self.sample_rate = sr.value
        self.total_samples = total.value  # 0 = unknown

    def read(self, count: int) -> np.ndarray:
        """The next `count` samples (fewer at the end, none when done)."""
        if self._h is None:
            raise ValueError("stream closed")
        out = np.empty((count,), np.float32)
        n = self._lib.ocm_flac_read(self._h, _fptr(out), count)
        _count("flac_read")
        if n < 0:
            raise IOError(f"ocm_flac_read failed rc={n}")
        return out[:n].copy()

    def close(self) -> None:
        if self._h is not None:
            self._lib.ocm_flac_close(self._h)
            self._h = None

    def __enter__(self) -> "FlacStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
