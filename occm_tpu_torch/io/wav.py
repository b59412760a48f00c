"""Host-side audio decode: the port's own copy of `occm_tpu/io/wav.py`.

- WAV (PCM 8/16/24/32-bit and float32/64): pure-NumPy RIFF parser.
- Optional resampling to a target rate via scipy polyphase filtering
  (librosa.load(sr=16000) equivalent; sr=None keeps the native rate).

Multi-channel audio is averaged to mono, matching librosa.load(mono=True).
`load_audio` prefers the native C++ reader (`io.native`, WAV and FLAC)
and decodes in Python where the library is unavailable or rejects a file;
the two give the same waves bit for bit.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np


def _parse_wav(data: bytes) -> Tuple[np.ndarray, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos: pos + 4]
        size = struct.unpack("<I", data[pos + 4: pos + 8])[0]
        body = data[pos + 8: pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) >= 2:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1  # assume PCM sub-format

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
            x = x / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels]
        x = x.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sample_rate


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to float32 mono in [-1, 1]. Returns (wave, sr)."""
    with open(path, "rb") as f:
        return _parse_wav(f.read())


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa.load(sr=...) equivalent quality)."""
    if sr == target_sr:
        return x
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, sr).limit_denominator(1000)
    return resample_poly(x, frac.numerator, frac.denominator).astype(
        np.float32
    )


def _read_python(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from occm_tpu_torch.io.flac import read_flac

        return read_flac(path)
    return read_wav(path)


def load_audio(path: str, sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """librosa.load-style entry: decode (WAV or FLAC, by magic bytes; the
    native reader where it is available and takes the file, else Python)
    + optional resample to `sr`.

    sr=None keeps the native rate (reference: oc_training.py:219 uses
    sr=None; data_utils_SSL.py:76 uses sr=16000).
    """
    from occm_tpu_torch.io import native

    decoded = None
    if native.available():
        try:
            decoded = native.native_read_wav(path)
        except IOError:  # a layout the native reader does not take
            pass
    wave, native_sr = decoded or _read_python(path)
    if sr is not None and native_sr != sr:
        return resample(wave, native_sr, sr), sr
    return wave, native_sr


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float32 mono to 16-bit PCM WAV (test fixtures / tooling)."""
    pcm = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    data = pcm.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)
