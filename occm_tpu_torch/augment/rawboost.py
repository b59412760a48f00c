"""RawBoost raw-waveform augmentation on the device (port of
`occm_tpu.augment.rawboost`; reference: RawBoost.py, dispatcher
data_utils_SSL.py:111-173).

1. LnL convolutive noise: N_f random band-stop ("notch") FIR cascades
   applied to the powers x^(i+1), summed, demeaned, peak-normalised.
2. ISD impulsive signal-dependent noise: a uniform n-subset of the samples
   gets signal-proportional impulses.
3. SSI stationary coloured additive noise: white noise shaped by a random
   notch cascade, scaled to a random SNR.

PyTorch cannot reproduce JAX's threefry draws, so every random function is
split in two:
- a draw (`draw_rawboost`) that makes every random number the algorithm
  needs from an explicit `torch.Generator` on its device: raw U[0, 1)
  uniforms and N(0, 1) normals, batched [B, ...], with static shapes;
- a deterministic apply (`process_rawboost` and the functions it calls)
  that takes x [B, L], those draws and optional valid lengths [B], and
  maps the uniforms to their ranges as the JAX package does, in fp32:
  lo + (hi - lo) * u (for LnL's lowered gains lo > hi).
Given the JAX package's own uniforms and normals, the apply computes its
outputs (tests/test_torch_rawboost.py).

The whole batch goes through one set of batched ops, and nothing reads a
device value on the host (tap counts, group delays and ISD's subset size
stay device tensors), so the augmentation runs inside a CUDA graph of the
training step (`train.graph`):
- the notch cascade is the product of its bands' spectra on a 1024-point
  FFT (its full length nBands * (maxCoeff + 1) - (nBands - 1) fits in
  bank_len <= 1024), and scipy's 512-point freqz is the first half of the
  same 1024-point FFT;
- the FIR pass is an FFT convolution (rfft / irfft at the next power of two
  >= L + bank_len - 1; FFTs have no TF32 path, which cuDNN's convolutions
  take by default) and the centred crop a per-row gather at the group
  delay (support + 1) // 2;
- ISD's subset is the n_sel smallest of per-sample uniforms, ties broken by
  index as a stable argsort would: the n_sel-th smallest value comes from
  one row sort (the JAX package bisects the float bits in 31 passes
  instead, because a sort is slow on a TPU), and an integer cumsum over
  the ties picks the first of them.

Every statistic (mean, peak, norms) honours `lengths`, so augmenting
zero-padded buffers matches augmenting the unpadded signals.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from occm_tpu_torch.config import RawBoostConfig

_FFT_FREQZ = 1024  # 2 * 512 -> scipy freqz's default worN=512 grid

#: the stages of each algo, in the order they run (algo 8 runs LnL and ISD
#: on the same input and sums them)
STAGES = {0: (), 1: ("lnl",), 2: ("isd",), 3: ("ssi",),
          4: ("lnl", "isd", "ssi"), 5: ("lnl", "isd"), 6: ("lnl", "ssi"),
          7: ("isd", "ssi"), 8: ("lnl", "isd")}

Draws = Dict[str, Dict[str, torch.Tensor]]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _valid_mask(lengths: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """[B, n]: 1 where the sample index is below the row's length."""
    idx = torch.arange(n, device=lengths.device)
    return (idx < lengths[:, None]).to(dtype)


def norm_wav(x: torch.Tensor, always: bool,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Peak normalisation of each row of x [B, L] (reference:
    RawBoost.py:20-25): always=True divides by max |x|, else only rows
    whose peak exceeds 1."""
    a = x.abs()
    if lengths is not None:
        a = a * _valid_mask(lengths, x.shape[-1], x.dtype)
    peak = a.amax(dim=-1, keepdim=True).clamp_min(torch.finfo(x.dtype).tiny)
    if always:
        return x / peak
    return torch.where(peak > 1.0, x / peak, x)


def _rand_range(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """lo + (hi - lo) * u, as the JAX package maps its uniforms (also for
    lo > hi, the reference's lowered LnL gains)."""
    return lo + (hi - lo) * u


def firwin_bandstop(c: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                    fs: float, max_taps: int) -> torch.Tensor:
    """Hamming-window band-stop FIR design, scipy.signal.firwin(c, [f1, f2],
    window='hamming', fs=fs) (pass_zero=True: passbands [0, f1] and
    [f2, Nyquist]), batched: c, f1, f2 [...] (c an odd tap count <=
    max_taps) -> [..., max_taps], taps from c on zero."""
    c = c.to(torch.float32)[..., None]
    n = torch.arange(max_taps, dtype=torch.float32, device=c.device)
    mask = (n < c).to(torch.float32)
    m = n - 0.5 * (c - 1.0)
    nyq = fs / 2.0
    f1n = f1[..., None] / nyq
    f2n = f2[..., None] / nyq
    # ideal response: passband [0, f1n] + passband [f2n, 1]
    h = f1n * torch.sinc(f1n * m) + torch.sinc(m) - f2n * torch.sinc(f2n * m)
    # symmetric Hamming window of length c on the first c taps
    win = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n
                                  / torch.clamp(c - 1.0, min=1.0))
    h = h * win * mask
    # unity gain at DC: divide by the tap sum
    return h / h.sum(dim=-1, keepdim=True)


def notch_from_draws(fcs: torch.Tensor, bws: torch.Tensor, cs: torch.Tensor,
                     G: torch.Tensor, fs: float, max_taps: int,
                     bank_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic core of genNotchCoeffs (reference: RawBoost.py:28-48),
    batched: centre frequencies, bandwidths and odd tap counts [...,
    nBands], the gain G [...] in dB. Returns (b [..., bank_len], support
    [...]), support = sum(cs) - (nBands - 1) the cascade's true length;
    taps from support on are zero."""
    n_bands = fcs.shape[-1]
    f1 = fcs - bws / 2.0
    f2 = fcs + bws / 2.0
    f1 = torch.where(f1 <= 0.0, 1.0 / 1000.0, f1)
    f2 = torch.where(f2 >= fs / 2.0, fs / 2.0 - 1.0 / 1000.0, f2)
    h = firwin_bandstop(cs, f1, f2, fs, max_taps)       # [..., nB, taps]
    # the cascade (np.convolve chain) as the product of the bands' spectra:
    # its full length, at most bank_len, fits in the FFT, so nothing wraps
    n_fft = max(_FFT_FREQZ, _next_pow2(bank_len))
    spec = torch.fft.rfft(h, n=n_fft)
    H = spec[..., 0, :]
    for i in range(1, n_bands):
        H = H * spec[..., i, :]
    support = cs.to(torch.int64).sum(dim=-1) - (n_bands - 1)
    taps = torch.arange(bank_len, device=fcs.device)
    b = torch.fft.irfft(H, n=n_fft)[..., :bank_len]
    b = torch.where(taps < support[..., None], b, 0.0)
    # freqz peak normalisation and dB gain (reference: RawBoost.py:45-47):
    # 512 points over [0, pi) are the first half of a 1024-point FFT
    peak = torch.fft.rfft(b, n=_FFT_FREQZ)[..., :_FFT_FREQZ // 2].abs()
    peak = peak.amax(dim=-1, keepdim=True)
    b = (10.0 ** (G / 20.0))[..., None] * b / peak
    return b, support


def notch_draws(band: torch.Tensor, gain: torch.Tensor,
                cfg: RawBoostConfig, min_g, max_g):
    """genNotchCoeffs' draws (reference: RawBoost.py:28-40) from their
    uniforms: band [..., nBands, 3] (centre frequency, bandwidth, tap
    count) and gain [...], the gain in [min_g, max_g) (floats, or tensors
    broadcasting against gain). Returns (fcs, bws, cs, G); the tap counts
    cs are int32, floored and forced odd."""
    fcs = _rand_range(band[..., 0], cfg.minF, cfg.maxF)
    bws = _rand_range(band[..., 1], cfg.minBW, cfg.maxBW)
    cs = torch.floor(_rand_range(band[..., 2], cfg.minCoeff,
                                 cfg.maxCoeff)).to(torch.int32)
    cs = torch.where(cs % 2 == 0, cs + 1, cs)  # odd (RawBoost.py:35-36)
    return fcs, bws, cs, _rand_range(gain, min_g, max_g)


def gen_notch_coeffs(band: torch.Tensor, gain: torch.Tensor,
                     cfg: RawBoostConfig, min_g, max_g
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random notch cascade (reference: RawBoost.py:28-48) from its
    uniforms (see `notch_draws`): (b [..., bank_len], support [...])."""
    max_taps = cfg.maxCoeff + 1
    return notch_from_draws(*notch_draws(band, gain, cfg, min_g, max_g),
                            float(cfg.fs), max_taps, cfg.nBands * max_taps)


def fir_filter_centered(x: torch.Tensor, b: torch.Tensor,
                        support: torch.Tensor) -> torch.Tensor:
    """Zero-phase-centred FIR pass (reference: RawBoost.py:51-56) of each
    row: full_conv(x, b)[(support + 1) // 2 :][:L] for x [..., L], b [...,
    bank_len], support [...], by FFT convolution and a per-row gather."""
    L = x.shape[-1]
    n_fft = _next_pow2(L + b.shape[-1] - 1)
    full = torch.fft.irfft(torch.fft.rfft(x, n=n_fft)
                           * torch.fft.rfft(b, n=n_fft), n=n_fft)
    offset = (support.to(torch.int64) + 1) // 2
    idx = offset[..., None] + torch.arange(L, device=x.device)
    return torch.gather(full, -1, idx)


def lnl_convolutive_noise(x: torch.Tensor, draws: Dict[str, torch.Tensor],
                          cfg: RawBoostConfig,
                          lengths: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Linear and non-linear convolutive noise (reference: RawBoost.py:
    59-69): an independent notch cascade on each power x^(i+1), i < N_f,
    the gain range lowered by the LinNonLin bias from i = 1 on. draws:
    "band" [B, N_f, nBands, 3] and "gain" [B, N_f] uniforms."""
    mask = None if lengths is None else _valid_mask(lengths, x.shape[-1],
                                                    x.dtype)
    # gain ranges [N_f], made on the device (a host copy cannot be
    # captured into a CUDA graph)
    first = torch.arange(cfg.N_f, device=x.device) == 0
    lo = torch.where(first, float(cfg.minG),
                     float(cfg.minG - cfg.minBiasLinNonLin))
    hi = torch.where(first, float(cfg.maxG),
                     float(cfg.maxG - cfg.maxBiasLinNonLin))
    b, support = gen_notch_coeffs(draws["band"], draws["gain"], cfg, lo, hi)
    powers, p = [], x
    for i in range(cfg.N_f):
        if i:
            p = p * x
        powers.append(p)
    xs = torch.stack(powers, dim=1)                   # [B, N_f, L]
    if mask is not None:
        xs = xs * mask[:, None, :]
    y = fir_filter_centered(xs, b, support).sum(dim=1)
    if mask is not None:
        y = y * mask
        n = lengths.clamp_min(1).to(x.dtype)[:, None]
        y = (y - y.sum(dim=-1, keepdim=True) / n) * mask
        return norm_wav(y, False, lengths)
    y = y - y.mean(dim=-1, keepdim=True)
    return norm_wav(y, False)


def _n_smallest_mask(u: torch.Tensor, n_sel: torch.Tensor) -> torch.Tensor:
    """mask[b, i] = True iff u[b, i] is among the n_sel[b] smallest entries
    of row b (non-negative floats; ties broken by index, as a stable
    argsort would). The n_sel-th smallest value v comes from a row sort;
    the entries below v are taken, and of those equal to v the first
    n_sel - count(below) by index."""
    n_sel = n_sel.to(torch.int64)
    srt = torch.sort(u, dim=-1).values
    pos = (n_sel - 1).clamp(0, u.shape[-1] - 1)[:, None]
    v = torch.gather(srt, -1, pos)                    # [B, 1]
    below = u < v
    ties = u == v
    k_rem = n_sel - below.sum(dim=-1)
    first = torch.cumsum(ties.to(torch.int32), dim=-1) <= k_rem[:, None]
    return below | (ties & first)


def isd_selection(draws: Dict[str, torch.Tensor], cfg: RawBoostConfig,
                  length: int, lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ISD's subset from its draws: (n_sel [B] int32, selected [B, length]
    bool), n_sel = floor(n_valid * beta / 100) and the n_sel valid samples
    of smallest "perm" uniform (invalid samples rank last)."""
    beta = _rand_range(draws["beta"], 0.0, float(cfg.P))
    if lengths is None:
        n_valid = torch.full_like(beta, float(length))
    else:
        n_valid = lengths.to(torch.float32)
    n_sel = torch.floor(n_valid * beta / 100.0).to(torch.int32)
    u = draws["perm"]
    if lengths is not None:
        u = torch.where(_valid_mask(lengths, length, torch.bool), u, 2.0)
    return n_sel, _n_smallest_mask(u, n_sel)


def isd_additive_noise(x: torch.Tensor, draws: Dict[str, torch.Tensor],
                       cfg: RawBoostConfig,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Impulsive signal-dependent noise (reference: RawBoost.py:73-84): the
    samples `isd_selection` picks get x * g_sd * f_r added, f_r a product
    of two centred uniforms. draws: "beta" [B], and "perm", "f1", "f2"
    [B, L] uniforms."""
    _, selected = isd_selection(draws, cfg, x.shape[-1], lengths)
    f_r = (2.0 * draws["f1"] - 1.0) * (2.0 * draws["f2"] - 1.0)
    y = x + selected.to(x.dtype) * float(cfg.g_sd) * x * f_r
    return norm_wav(y, False, lengths)


def ssi_additive_noise(x: torch.Tensor, draws: Dict[str, torch.Tensor],
                       cfg: RawBoostConfig,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Stationary signal-independent coloured noise at a random SNR
    (reference: RawBoost.py:89-97; no final peak normalisation). draws:
    "noise" [B, L] normals, "band" [B, nBands, 3], "gain" [B] and "snr"
    [B] uniforms."""
    mask = None if lengths is None else _valid_mask(lengths, x.shape[-1],
                                                    x.dtype)
    noise = draws["noise"]
    if mask is not None:
        noise = noise * mask
    b, support = gen_notch_coeffs(draws["band"], draws["gain"], cfg,
                                  float(cfg.minG), float(cfg.maxG))
    noise = fir_filter_centered(noise, b, support)
    if mask is not None:
        noise = noise * mask
    noise = norm_wav(noise, True, lengths)
    snr = _rand_range(draws["snr"], float(cfg.SNRmin), float(cfg.SNRmax))
    noise_norm = torch.sqrt(torch.sum(noise * noise, dim=-1, keepdim=True))
    xx = x * x if mask is None else x * x * mask
    x_norm = torch.sqrt(torch.sum(xx, dim=-1, keepdim=True))
    noise = noise / noise_norm.clamp_min(1e-20) * x_norm / (
        10.0 ** (0.05 * snr))[:, None]
    return x + noise


def draw_rawboost(cfg: RawBoostConfig, batch: int, length: int,
                  generator: torch.Generator) -> Draws:
    """Every random number `process_rawboost` needs for cfg.algo on a
    [batch, length] input, drawn from `generator` on its device, stage by
    stage in STAGES order: {"lnl": {"band", "gain"}, "isd": {"beta",
    "perm", "f1", "f2"}, "ssi": {"noise", "band", "gain", "snr"}}."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    draws: Draws = {}
    for stage in STAGES[cfg.algo]:
        if stage == "lnl":
            draws[stage] = {"band": u(batch, cfg.N_f, cfg.nBands, 3),
                            "gain": u(batch, cfg.N_f)}
        elif stage == "isd":
            draws[stage] = {"beta": u(batch), "perm": u(batch, length),
                            "f1": u(batch, length), "f2": u(batch, length)}
        else:
            draws[stage] = {
                "noise": torch.randn((batch, length), generator=generator,
                                     device=dev),
                "band": u(batch, cfg.nBands, 3), "gain": u(batch),
                "snr": u(batch)}
    return draws


_APPLY = {"lnl": lnl_convolutive_noise, "isd": isd_additive_noise,
          "ssi": ssi_additive_noise}


def process_rawboost(x: torch.Tensor, draws: Draws, cfg: RawBoostConfig,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Algorithm dispatcher 0-8 (reference: data_utils_SSL.py:111-173) on
    x [B, L] with `draw_rawboost`'s draws: the stages in series, or for
    algo 8 LnL and ISD in parallel, summed and peak-normalised."""
    if cfg.algo not in STAGES:
        raise ValueError(f"RawBoost algo {cfg.algo} is not one of 0-8")
    if cfg.algo == 8:
        y = (lnl_convolutive_noise(x, draws["lnl"], cfg, lengths)
             + isd_additive_noise(x, draws["isd"], cfg, lengths))
        return norm_wav(y, False, lengths)
    for stage in STAGES[cfg.algo]:
        x = _APPLY[stage](x, draws[stage], cfg, lengths)
    return x


def batch_rawboost(generator: torch.Generator, x: torch.Tensor,
                   cfg: RawBoostConfig,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RawBoost on a batch x [B, L] (+ optional valid lengths [B]) with
    independent draws per utterance from `generator`, which lies on x's
    device; algo 0 returns x and draws nothing."""
    if cfg.algo == 0:
        return x
    draws = draw_rawboost(cfg, x.shape[0], x.shape[-1], generator)
    return process_rawboost(x, draws, cfg, lengths)
