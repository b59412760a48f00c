"""DSP feature bank in PyTorch (port of `occm_tpu.audio.features`).

The reference wraps spafe / pywt / ssqueezepy for LFCC / MFCC / BFCC /
CQCC / LPC(C) / mel / CWT / SSQ-CWT extraction with a 30 ms / 15 ms
Hamming sliding window, pre-emphasis 0.97, nfft 2048 and MVN
normalisation (reference: utils.py:21-188). None of these feed the
shipped entry points, so the contract is the JAX package's: the same
feature families and framing conventions, here on the device of the
input.

Every extractor takes waves y [..., T] (any leading dims: a batch, where
the JAX package uses vmap) and computes in y's dtype (float32 or float64;
complex64 / complex128 for the spectra) on y's device. The filter banks
and bases are built in that dtype on that device. LPC's Levinson-Durbin
and LPC -> cepstrum recursions run `order` steps, each on every frame of
every wave at once.

Also the dense-padding helpers (numpy) and dataset z-normalisation
(reference: utils.py:190-248).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------- framing


def pre_emphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], dim=-1)


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, frame_len] (drops the ragged tail)."""
    if x.shape[-1] < frame_len:
        return x.new_zeros(x.shape[:-1] + (0, frame_len))
    return x.unfold(-1, frame_len, hop)


def hamming(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    i = torch.arange(n, dtype=dtype, device=device)
    return 0.54 - 0.46 * torch.cos(2.0 * math.pi * i / (n - 1))


def stft_mag(x: torch.Tensor, fs: int, win_s: float = 0.03,
             hop_s: float = 0.015, nfft: int = 2048,
             pre_emph: float = 0.97) -> torch.Tensor:
    """|STFT| with the reference framing conventions: [..., T] ->
    [..., frames, nfft // 2 + 1]."""
    if pre_emph:
        x = pre_emphasis(x, pre_emph)
    frame_len = int(round(win_s * fs))
    hop = int(round(hop_s * fs))
    frames = frame_signal(x, frame_len, hop) * hamming(frame_len, x.dtype,
                                                       x.device)
    return torch.fft.rfft(frames, n=nfft, dim=-1).abs()


# ----------------------------------------------------------- filterbanks

def _hz_to_mel(f):
    return 2595.0 * torch.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def _hz_to_bark(f):
    return 6.0 * torch.asinh(f / 600.0)


def _bark_to_hz(b):
    return 600.0 * torch.sinh(b / 6.0)


def _triangular_fb(n_filts: int, nfft: int, fs: int, low: float,
                   high: float, scale: str, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """[n_filts, nfft // 2 + 1] triangular filters on a warped axis."""
    if scale == "mel":
        fwd, inv = _hz_to_mel, _mel_to_hz
    elif scale == "bark":
        fwd, inv = _hz_to_bark, _bark_to_hz
    else:  # linear
        fwd = inv = lambda f: f
    ends = fwd(torch.tensor([low, high], dtype=dtype, device=device))
    pts = inv(torch.linspace(float(ends[0]), float(ends[1]), n_filts + 2,
                             dtype=dtype, device=device))
    bins = torch.fft.rfftfreq(nfft, 1.0 / fs, dtype=dtype, device=device)
    left, centre, right = (pts[:-2, None], pts[1:-1, None], pts[2:, None])
    up = (bins[None, :] - left) / torch.clamp(centre - left, min=1e-8)
    down = (right - bins[None, :]) / torch.clamp(right - centre, min=1e-8)
    return torch.clamp(torch.minimum(up, down), 0.0, 1.0)


def _dct_ii(x: torch.Tensor, n_out: Optional[int] = None) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis."""
    n = x.shape[-1]
    k = torch.arange(n_out or n, dtype=x.dtype, device=x.device)[:, None]
    m = torch.arange(n, dtype=x.dtype, device=x.device)[None, :]
    basis = torch.cos(math.pi * k * (2 * m + 1) / (2 * n))
    scale = torch.where(k == 0, math.sqrt(1.0 / n), math.sqrt(2.0 / n))
    return x @ (basis * scale).T


def mvn(feats: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-coefficient mean-variance normalisation over the frames of
    [..., frames, coeffs] (spafe normalize='mvn')."""
    mu = feats.mean(dim=-2, keepdim=True)
    sd = feats.std(dim=-2, unbiased=False, keepdim=True)
    return (feats - mu) / torch.clamp(sd, min=eps)


def _cepstra(x, fs, n_filts, scale, n_ceps, nfft, low, high, normalize,
             pre_emph):
    mag = stft_mag(x, fs, nfft=nfft, pre_emph=pre_emph)
    fb = _triangular_fb(n_filts, nfft, fs, low, high, scale, mag.dtype,
                        mag.device)
    energies = torch.clamp(mag ** 2 @ fb.T, min=1e-10)
    ceps = _dct_ii(torch.log(energies), n_ceps)
    return mvn(ceps) if normalize else ceps


def extract_lfcc(y, sr, n_filts: int = 128, n_ceps: int = 13,
                 nfft: int = 2048, low: float = 0.0, high: float = 8000.0,
                 normalize: bool = True, pre_emph: float = 0.97):
    """Linear-frequency cepstra [..., frames, n_ceps] (reference:
    utils.py:127-138 config)."""
    return _cepstra(y, sr, n_filts, "linear", n_ceps, nfft, low, high,
                    normalize, pre_emph)


def extract_mfcc(y, sr, n_filts: int = 1024, n_ceps: int = 13,
                 nfft: int = 2048, low: float = 0.0, high: float = 8000.0,
                 normalize: bool = True, pre_emph: float = 0.97):
    """Mel-frequency cepstra (reference: utils.py:55-66 calls spafe with
    nfilts=1024, nfft=2048; the defaults mirror that call)."""
    return _cepstra(y, sr, n_filts, "mel", n_ceps, nfft, low, high,
                    normalize, pre_emph)


def extract_bfcc(y, sr, n_filts: int = 1024, n_ceps: int = 13,
                 nfft: int = 2048, low: float = 0.0, high: float = 8000.0,
                 normalize: bool = True, pre_emph: float = 0.97):
    """Bark-frequency cepstra (reference: utils.py:21-32 config)."""
    return _cepstra(y, sr, n_filts, "bark", n_ceps, nfft, low, high,
                    normalize, pre_emph)


def extract_mel(y, sr, n_filts: int = 1024, nfft: int = 2048,
                low: float = 0.0, high: float = 8000.0,
                pre_emph: float = 0.97):
    """Mel spectrogram [..., frames, n_filts] (reference: utils.py:68-78)."""
    mag = stft_mag(y, sr, nfft=nfft, pre_emph=pre_emph)
    fb = _triangular_fb(n_filts, nfft, sr, low, high, "mel", mag.dtype,
                        mag.device)
    return mag ** 2 @ fb.T


# ------------------------------------------------------------------- LPC

def extract_lpc(y, sr, order: int = 13, win_s: float = 0.03,
                hop_s: float = 0.015) -> torch.Tensor:
    """Frame-wise LPC by Levinson-Durbin (reference: utils.py:165-172):
    [..., T] -> [..., frames, order + 1] with a0 = 1."""
    frame_len = int(round(win_s * sr))
    hop = int(round(hop_s * sr))
    frames = frame_signal(y, frame_len, hop) * hamming(frame_len, y.dtype,
                                                       y.device)
    # the autocorrelation through the power spectrum of the zero-padded
    # frame (lags 0..order)
    spec = torch.fft.rfft(frames, n=2 * frame_len, dim=-1).abs() ** 2
    r = torch.fft.irfft(spec, n=2 * frame_len, dim=-1)[..., :order + 1]
    a = torch.zeros_like(r)
    a[..., 0] = 1.0
    err = torch.clamp(r[..., 0], min=1e-10)
    for i in range(1, order + 1):
        # k = -(r[i] + sum_{j=1..i-1} a[j] r[i-j]) / err
        acc = (a[..., 1:i] * r[..., 1:i].flip(-1)).sum(-1)
        k = -(r[..., i] + acc) / err
        # a[j] += k a[i-j] for j in 1..i-1, then a[i] = k
        a = torch.cat([a[..., :1],
                       a[..., 1:i] + k[..., None] * a[..., 1:i].flip(-1),
                       k[..., None], a[..., i + 1:]], dim=-1)
        err = torch.clamp(err * (1.0 - k * k), min=1e-10)
    return a


def extract_lpcc(y, sr, order: int = 13, **kwargs) -> torch.Tensor:
    """LPC cepstra from the LPC coefficients (reference: utils.py:47-53):
    [..., frames, order + 1], c[0] = 0."""
    a = extract_lpc(y, sr, order=order, **kwargs)
    c = torch.zeros_like(a)
    for n in range(1, order + 1):
        # c[n] = -a[n] - sum_{k=1..n-1} (k/n) c[k] a[n-k]
        k = torch.arange(1, n, dtype=a.dtype, device=a.device)
        inner = ((k / n) * c[..., 1:n] * a[..., 1:n].flip(-1)).sum(-1)
        c = torch.cat([c[..., :n], (-a[..., n] - inner)[..., None],
                       c[..., n + 1:]], dim=-1)
    return c


# ------------------------------------------------------------------ CQCC

def extract_cqcc(y, sr, n_bins: int = 96, bins_per_octave: int = 12,
                 fmin: float = 15.625, n_ceps: int = 13,
                 hop_s: float = 0.015, normalize: bool = True
                 ) -> torch.Tensor:
    """Constant-Q cepstral coefficients (reference: utils.py:34-45):
    Gaussian constant-Q bands on the rfft grid of 2048-sample frames, log
    power, DCT -> [..., frames, n_ceps]."""
    nfft = 2048
    mag = stft_mag(y, sr, win_s=nfft / sr, hop_s=hop_s, nfft=nfft,
                   pre_emph=0.97)
    freqs = np.fft.rfftfreq(nfft, 1.0 / sr)
    centres = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    bw = centres / q
    fb = np.exp(
        -0.5 * ((freqs[None, :] - centres[:, None]) / (bw[:, None] / 2)) ** 2)
    fb /= np.maximum(fb.sum(axis=1, keepdims=True), 1e-8)
    fb = torch.as_tensor(fb, dtype=mag.dtype, device=mag.device)
    energies = torch.clamp(mag ** 2 @ fb.T, min=1e-10)
    ceps = _dct_ii(torch.log(energies), n_ceps)
    return mvn(ceps) if normalize else ceps


# ------------------------------------------------------------------- CWT

def extract_cwt(y, sr: int = 16000, widths: Optional[np.ndarray] = None,
                w0: float = 5.0) -> torch.Tensor:
    """Morlet continuous wavelet transform (reference: utils.py:84-96),
    FFT-based convolution with scaled Morlet atoms: [..., T] -> complex
    [..., n_scales, T]."""
    if widths is None:
        widths = np.arange(1, 301, 1)
    n = y.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    yf = torch.fft.fft(y, n=nfft, dim=-1)
    omega = torch.fft.fftfreq(nfft, dtype=y.dtype,
                              device=y.device) * 2 * math.pi
    scales = torch.as_tensor(np.asarray(widths, np.float32), device=y.device
                             ).to(y.dtype)[:, None]
    # Morlet in the frequency domain: pi^-1/4 sqrt(2 pi s)
    # exp(-(s w - w0)^2 / 2), w > 0
    sw = scales * omega[None, :]
    kernel = (math.pi ** -0.25 * torch.sqrt(2 * math.pi * scales)
              * torch.exp(-0.5 * (sw - w0) ** 2) * (omega[None, :] > 0))
    return torch.fft.ifft(yf[..., None, :] * kernel, dim=-1)[..., :n]


def _ssq_bins(W: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The instantaneous-frequency bin of each CWT entry W [..., S, T]:
    the phase derivative (central difference, wrapped to [-pi, pi)) in
    cycles per sample over the Nyquist 0.5, times n_bins - 1, truncated
    and clipped to [0, n_bins)."""
    phase = torch.angle(W)
    dphase = (torch.roll(phase, -1, dims=-1)
              - torch.roll(phase, 1, dims=-1)) / 2.0
    # a floor remainder, as Python's and jnp's % for a positive divisor
    dphase = torch.remainder(dphase + math.pi, 2 * math.pi) - math.pi
    inst_freq = dphase.abs() / (2 * math.pi)
    return torch.clamp((inst_freq / 0.5 * (n_bins - 1)).to(torch.int64),
                       0, n_bins - 1)


def extract_ssqcwt(y, sr: int = 16000, widths: Optional[np.ndarray] = None,
                   w0: float = 5.0, n_freq_bins: Optional[int] = None
                   ) -> torch.Tensor:
    """Synchrosqueezed CWT (reference: utils.py:80-82,113-115): each CWT
    entry's magnitude added to its instantaneous-frequency bin (`_ssq_bins`)
    -> [..., n_bins, T]."""
    if widths is None:
        widths = np.arange(1, 301, 1)
    W = extract_cwt(y, sr, widths, w0)
    n_bins = n_freq_bins or len(widths)
    bins = _ssq_bins(W, n_bins)
    mag = W.abs()
    out = mag.new_zeros(mag.shape[:-2] + (n_bins, mag.shape[-1]))
    return out.scatter_add_(-2, bins, mag)


# --------------------------------------------------------- dense helpers

def pad_to_dense_1d(arrays) -> np.ndarray:
    """reference: utils.py:190-199 (+= semantics kept)."""
    maxlen = max(len(r) for r in arrays)
    out = np.zeros((len(arrays), maxlen))
    for i, row in enumerate(arrays):
        out[i, : len(row)] += row
    return out


def pad_to_dense_2d(arrays) -> np.ndarray:
    """reference: utils.py:217-229 (pad trailing columns)."""
    max_cols = max(a.shape[1] for a in arrays)
    rows = arrays[0].shape[0]
    out = np.zeros((len(arrays), rows, max_cols))
    for i, a in enumerate(arrays):
        out[i, :, : a.shape[1]] = a
    return out


def normalize_dataset(dataset: torch.Tensor) -> torch.Tensor:
    """Global z-normalisation (reference: utils.py:231-248 intent)."""
    mu = dataset.mean()
    sd = dataset.std(unbiased=False)
    return (dataset - mu) / torch.clamp(sd, min=1e-8)
