"""The port's DSP feature bank (`occm_tpu_torch.audio.features`) against
the JAX package's (`occm_tpu.audio.features`) and against the oracles of
the JAX suite (tests/test_features.py:200-345), torch pinned to one
thread.

The port's extractors take a batch [B, T] where the JAX ones take one
utterance (and vmap): each is held row by row to the JAX extractor on the
same seeded fp32 waves. Tolerances (fp32 on both sides, the spectra and
filter banks made by different FFT and linspace code):
- spectra, mel energies, CWT: rtol 1e-4 of the largest magnitude;
- cepstra (log, DCT, MVN) and CQCC: atol 2e-3 (MVN divides by each
  coefficient's spread over the frames);
- LPC / LPCC (Levinson-Durbin in another summation order): atol 1e-3;
- the synchrosqueezed CWT: each entry's bin is the truncation of its
  instantaneous frequency times (n_bins - 1), so an fp32 rounding at a
  bin edge moves that entry's magnitude to the next bin. In fp64 on both
  sides (JAX under enable_x64) every bin is the same (the magnitudes at
  rtol 1e-6: JAX keeps one factor fp32); in fp32 at most
  0.2 % of the entries may sit in another bin, and the columns' sums (the
  magnitudes binned) agree at rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.audio import features as J
from occm_tpu_torch.audio import features as T
from test_features import _naive_cepstra, _naive_warp

SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _waves(n=2, samples=SR, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    rows = [0.4 * np.sin(2 * np.pi * (300 + 450 * i) * t)
            + 0.1 * rng.normal(size=samples) for i in range(n)]
    return np.asarray(rows, np.float32)


def _jax_rows(fn, x, **kw):
    return np.stack([np.asarray(fn(jnp.asarray(row), SR, **kw))
                     for row in x])


def _rel_max(got, want, rtol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=rtol)


def test_framing_and_stft_match_jax():
    x = _waves()
    frames = T.frame_signal(torch.from_numpy(x), 480, 240)
    assert frames.shape == (2, (SR - 480) // 240 + 1, 480)
    np.testing.assert_array_equal(
        frames[1].numpy(), np.asarray(J.frame_signal(jnp.asarray(x[1]), 480,
                                                     240)))
    assert T.frame_signal(torch.zeros(2, 100), 480, 240).shape == (2, 0, 480)
    np.testing.assert_allclose(T.hamming(480).numpy(),
                               np.asarray(J.hamming(480)), atol=1e-7)
    got = T.stft_mag(torch.from_numpy(x), SR).numpy()
    _rel_max(got, _jax_rows(J.stft_mag, x), 1e-4)


@pytest.mark.parametrize("name", ["extract_lfcc", "extract_mfcc",
                                  "extract_bfcc", "extract_cqcc"])
def test_cepstra_match_jax(name):
    x = _waves(seed=1)
    got = getattr(T, name)(torch.from_numpy(x), SR).numpy()
    want = _jax_rows(getattr(J, name), x)
    assert got.shape == want.shape and got.shape[-1] == 13
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_mel_matches_jax():
    x = _waves(seed=2)
    got = T.extract_mel(torch.from_numpy(x), SR, n_filts=64).numpy()
    _rel_max(got, _jax_rows(J.extract_mel, x, n_filts=64), 1e-4)


@pytest.mark.parametrize("name", ["extract_lpc", "extract_lpcc"])
def test_lpc_and_lpcc_match_jax(name):
    x = _waves(seed=3)
    got = getattr(T, name)(torch.from_numpy(x), SR, order=13).numpy()
    want = _jax_rows(getattr(J, name), x, order=13)
    assert got.shape == want.shape and got.shape[-1] == 14
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_cwt_matches_jax():
    x = _waves(samples=4000, seed=4)
    widths = np.arange(1, 61)
    got = T.extract_cwt(torch.from_numpy(x), SR, widths=widths).numpy()
    want = _jax_rows(J.extract_cwt, x, widths=widths)
    assert got.shape == want.shape == (2, 60, 4000)
    _rel_max(got, want, 1e-4)


def test_ssqcwt_matches_jax_bin_for_bin_in_fp64():
    """Every entry in JAX's bin: a moved one would show as a whole
    magnitude in two entries. (JAX's Morlet normalisation sqrt(2 pi s)
    stays fp32 under x64, its widths being fp32: the magnitudes agree at
    rtol 1e-6, the bins exactly.)"""
    x = _waves(samples=3000, seed=5)
    widths = np.arange(1, 61)
    with jax.enable_x64(True):
        want = np.stack([np.asarray(J.extract_ssqcwt(
            jnp.asarray(row, jnp.float64), SR, widths=widths)) for row in x])
    assert want.dtype == np.float64
    got = T.extract_ssqcwt(torch.from_numpy(x.astype(np.float64)), SR,
                           widths=widths).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_ssqcwt_matches_jax_in_fp32_up_to_bin_edges():
    x = _waves(samples=3000, seed=5)
    widths = np.arange(1, 61)
    got = T.extract_ssqcwt(torch.from_numpy(x), SR, widths=widths).numpy()
    want = _jax_rows(J.extract_ssqcwt, x, widths=widths)
    assert got.shape == want.shape == (2, 60, 3000)
    _rel_max(got.sum(axis=1), want.sum(axis=1), 1e-4)
    scale = np.abs(want).max()
    moved = np.abs(got - want) > 1e-4 * scale
    assert moved.mean() <= 2e-3, (int(moved.sum()), moved.size)


def test_mvn_normalize_and_dense_helpers():
    z = T.mvn(torch.from_numpy(np.random.default_rng(1).normal(
        5, 2, (3, 50, 7)).astype(np.float32)))
    np.testing.assert_allclose(z.mean(dim=1).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(z.std(dim=1, unbiased=False).numpy(), 1,
                               atol=1e-3)
    d = np.random.default_rng(0).normal(2.0, 3.0, (100,)).astype(np.float32)
    np.testing.assert_allclose(T.normalize_dataset(torch.from_numpy(d)),
                               np.asarray(J.normalize_dataset(
                                   jnp.asarray(d))), atol=1e-5)
    for fn in ("pad_to_dense_1d", "pad_to_dense_2d"):
        arrays = ([np.ones(2), np.ones(4) * 3] if fn.endswith("1d")
                  else [np.ones((3, 2)), np.ones((3, 5))])
        np.testing.assert_array_equal(getattr(T, fn)(arrays),
                                      getattr(J, fn)(arrays))


# ---------------------------------------- the JAX suite's oracles, on the port

@pytest.mark.parametrize("extractor,scale", [
    ("extract_lfcc", "linear"),
    ("extract_mfcc", "mel"),
    ("extract_bfcc", "bark"),
])
def test_cepstra_match_naive_oracle(extractor, scale):
    """tests/test_features.py:200-219."""
    fs, nfft, n_filts, n_ceps = 16000, 256, 10, 6
    rng = np.random.default_rng(11)
    t = np.arange(1600) / fs
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1330 * t)
         + 0.05 * rng.normal(size=t.shape)).astype(np.float32)
    ours = getattr(T, extractor)(torch.from_numpy(x), fs, n_filts=n_filts,
                                 n_ceps=n_ceps, nfft=nfft,
                                 high=7000.0).numpy()
    ref = _naive_cepstra(x, fs, n_filts, scale, n_ceps, nfft, 0.0, 7000.0)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)


def test_mel_spectrogram_matches_naive_oracle():
    """tests/test_features.py:222-250."""
    fs, nfft, n_filts = 16000, 256, 12
    rng = np.random.default_rng(12)
    x = (0.3 * rng.normal(size=1600)).astype(np.float32)
    ours = T.extract_mel(torch.from_numpy(x), fs, n_filts=n_filts,
                         nfft=nfft, high=7600.0).numpy()
    y = np.concatenate([x[:1], x[1:] - 0.97 * x[:-1]]).astype(np.float64)
    frame_len, hop = 480, 240
    win = 0.54 - 0.46 * np.cos(
        2 * np.pi * np.arange(frame_len) / (frame_len - 1))
    fwd, inv = _naive_warp("mel")
    pts = inv(np.linspace(fwd(np.float32(0.0)), fwd(np.float32(7600.0)),
                          n_filts + 2))
    bins = np.fft.rfftfreq(nfft, 1.0 / fs)
    rows = []
    for tdx in range((len(y) - frame_len) // hop + 1):
        p = np.abs(np.fft.rfft(y[tdx * hop:tdx * hop + frame_len] * win,
                               nfft)) ** 2
        rows.append([
            float((p * np.clip(np.minimum(
                (bins - pts[i]) / max(pts[i + 1] - pts[i], 1e-8),
                (pts[i + 2] - bins) / max(pts[i + 2] - pts[i + 1], 1e-8)),
                0, 1)).sum())
            for i in range(n_filts)
        ])
    np.testing.assert_allclose(ours, np.asarray(rows), rtol=2e-3, atol=1e-4)


def test_lpc_matches_toeplitz_solve_oracle():
    """tests/test_features.py:253-292: the Yule-Walker equations solved
    directly, the autocorrelation by its definition."""
    fs, order = 16000, 6
    rng = np.random.default_rng(13)
    x = np.zeros(2000)
    e = rng.normal(size=2000)
    for t in range(4, 2000):
        x[t] = (1.8 * x[t - 1] - 1.2 * x[t - 2] + 0.5 * x[t - 3]
                - 0.1 * x[t - 4]) * 0.5 + e[t]
    x = (x / np.abs(x).max()).astype(np.float32)
    ours = T.extract_lpc(torch.from_numpy(x), fs, order=order).numpy()
    frame_len, hop = 480, 240
    win = 0.54 - 0.46 * np.cos(
        2 * np.pi * np.arange(frame_len) / (frame_len - 1))
    n_frames = (len(x) - frame_len) // hop + 1
    assert ours.shape == (n_frames, order + 1)
    for t in range(n_frames):
        fr = (x[t * hop:t * hop + frame_len] * win).astype(np.float64)
        r = np.array([float(np.dot(fr[:frame_len - k], fr[k:]))
                      for k in range(order + 1)])
        R = np.array([[r[abs(i - j)] for j in range(order)]
                      for i in range(order)])
        a_tail = np.linalg.solve(R + 1e-10 * np.eye(order), -r[1:])
        np.testing.assert_allclose(ours[t], np.concatenate([[1.0], a_tail]),
                                   rtol=5e-3, atol=5e-3)


def test_lpcc_matches_recursion_oracle():
    """tests/test_features.py:295-311."""
    fs, order = 16000, 6
    x = (0.3 * np.random.default_rng(14).normal(size=1600)).astype(
        np.float32)
    a = T.extract_lpc(torch.from_numpy(x), fs, order=order).double().numpy()
    ours = T.extract_lpcc(torch.from_numpy(x), fs, order=order).numpy()
    for t in range(a.shape[0]):
        c = np.zeros(order + 1)
        for n in range(1, order + 1):
            acc = sum((k / n) * c[k] * a[t, n - k] for k in range(1, n))
            c[n] = -a[t, n] - acc
        np.testing.assert_allclose(ours[t], c, rtol=1e-4, atol=1e-5)


def test_cwt_matches_analytic_time_domain_wavelet():
    """tests/test_features.py:314-345: the direct convolution with the
    Morlet atom's closed-form inverse transform."""
    n = 128
    y = (0.5 * np.random.default_rng(15).normal(size=n)).astype(np.float32)
    widths = np.array([5.0, 10.0, 20.0])
    W = T.extract_cwt(torch.from_numpy(y), 16000, widths=widths,
                      w0=5.0).numpy()
    assert W.shape == (3, n)
    u = np.arange(-n + 1, n)
    for i, s in enumerate(widths):
        h = (np.pi ** -0.25) / np.sqrt(s) * np.exp(
            1j * 5.0 * u / s - u ** 2 / (2 * s ** 2))
        ref = np.array([sum(y[tau] * h[(t - tau) + n - 1]
                            for tau in range(n)) for t in range(n)])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(W[i] / scale, ref / scale, atol=5e-3,
                                   err_msg=f"scale {s}")
