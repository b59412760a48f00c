"""Build the port's CUDA kernels and load them through ctypes.

Every `occm_tpu_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a`, one
`nvcc` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, at first use,
into `occm_tpu_torch/build/`. The library's name carries a hash of the
sources, the headers they share (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
The library links nothing but the objects and the CUDA runtime: the TMA
kernels' descriptors are encoded through `cuTensorMapEncodeTiled`,
which it fetches from the driver with `cudaGetDriverEntryPoint` rather
than linking `-lcuda`.
Nothing here runs at import time: the CPU-only test host has no `nvcc`.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: ptxas's report (registers, shared memory, spills per kernel) of the last
#: build, "" when the library was already built
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from occm_tpu_torch/csrc at first use")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for s in _sources() + headers:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libocct_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the current sources are not built yet;
    returns the library path."""
    global build_seconds, build_log
    path = library_path()
    if os.path.exists(path):
        build_seconds = 0.0
        build_log = ""
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, logs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point's
    argument and return types declared."""
    global _lib
    if _lib is not None:  # the fast path of every launch: no lock
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            ll = ctypes.c_longlong
            lib.occm_flash_attn_fwd.argtypes = [
                p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll,
                ll, ctypes.c_float, p]
            lib.occm_flash_attn_fwd.restype = i
            # pointers, (b, h, T, t_valid, d), strides (sb, st, sh) of
            # each [b, T, h, d] input, scale, stream
            lib.occm_flash_attn_bwd_dq.argtypes = [
                *[p] * 8, *[i] * 5, *[ll] * 15, ctypes.c_float, p]
            lib.occm_flash_attn_bwd_dq.restype = i
            lib.occm_flash_attn_bwd_dkv.argtypes = [
                *[p] * 8, *[i] * 5, *[ll] * 12, ctypes.c_float, p]
            lib.occm_flash_attn_bwd_dkv.restype = i
            lib.occm_layernorm_bwd_scratch_bytes.argtypes = [i, i, i]
            lib.occm_layernorm_bwd_scratch_bytes.restype = ll
            lib.occm_layernorm_bwd.argtypes = [
                p, p, p, p, p, p, p, ll, i, i, ctypes.c_float, i, p]
            lib.occm_layernorm_bwd.restype = i
            f = ctypes.c_float
            lib.occm_fused_adam.argtypes = [
                i, p, p, p, p, p, p, i, f, f, f, f, f, f, p, p]
            lib.occm_fused_adam.restype = i
            lib.occm_ffn_gemm.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.occm_ffn_gemm.restype = i
            _lib = lib
        return _lib


def on_device(device: torch.device):
    """`torch.cuda.device(device)` around a launch, or nothing when the
    device is already current (the common case, which then costs no
    switch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# PyTorch's raw current-stream query (absent from CPU-only builds)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def raw_stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device`, as the integer a launch
    takes: the raw query builds no Stream object per launch."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(device).cuda_stream
    return _RAW_STREAM(device.index)
