"""The port's RawBoost (`occm_tpu_torch.augment`) against the JAX package's
(`occm_tpu.augment`).

PyTorch cannot reproduce JAX's threefry draws, so the port splits every
random function into a draw and a deterministic apply. These tests record
the uniforms and normals an un-jitted `occm_tpu.augment.process_rawboost`
draws (monkeypatched `jax.random.uniform` / `normal`), on the utterance keys
`batch_rawboost` splits from its key, hand them to the port's apply, and
hold its output to JAX's, for every algo 1-8 with and without valid
lengths.

Tolerances: outputs atol 1e-4. Both sides compute in fp32; the port
convolves by FFT where JAX convolves directly, and sums the N_f filtered
powers in another order, so they differ by float rounding (measured
below 1e-6 on these inputs, |x| <= 1). Tap counts, supports, crop offsets
and ISD masks are integers and held exactly; the FIR pieces at the JAX
suite's own tolerances against scipy (tests/test_rawboost.py:57,74).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import occm_tpu.augment.rawboost as JR
from occm_tpu.config import RawBoostConfig as JRawBoostConfig
from occm_tpu_torch.augment import (
    batch_rawboost, draw_rawboost, fir_filter_centered, firwin_bandstop,
    gen_notch_coeffs, norm_wav, notch_from_draws, process_rawboost)
from occm_tpu_torch.augment.rawboost import (
    STAGES, _n_smallest_mask, isd_selection, notch_draws)
from occm_tpu_torch.config import RawBoostConfig

FS = 16000
CFG = RawBoostConfig()
MAX_TAPS = CFG.maxCoeff + 1
BANK_LEN = CFG.nBands * MAX_TAPS
B, L = 2, 4000
LENGTHS = np.array([L, 2500], np.int32)
ATOL = 1e-4


def _x(seed=0, b=B, n=L, scale=0.2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)) * scale).astype(np.float32)


@contextlib.contextmanager
def _recorded():
    """Record the values of every jax.random.uniform / normal call."""
    calls = []
    real_u, real_n = jax.random.uniform, jax.random.normal

    def uniform(*a, **k):
        v = real_u(*a, **k)
        calls.append(np.asarray(v))
        return v

    def normal(*a, **k):
        v = real_n(*a, **k)
        calls.append(np.asarray(v))
        return v

    jax.random.uniform, jax.random.normal = uniform, normal
    try:
        yield calls
    finally:
        jax.random.uniform, jax.random.normal = real_u, real_n


def _parse(calls, algo):
    """One utterance's recorded draws -> the port's draws layout (the JAX
    package draws them stage by stage in STAGES order; a notch cascade
    draws centre, bandwidth and tap count per band, then the gain)."""
    it = iter(calls)

    def notch():
        band = np.array([[next(it) for _ in range(3)]
                         for _ in range(CFG.nBands)], np.float32)
        return band, np.float32(next(it))

    out = {}
    for stage in STAGES[algo]:
        if stage == "lnl":
            bands, gains = zip(*[notch() for _ in range(CFG.N_f)])
            out[stage] = {"band": np.stack(bands),
                          "gain": np.array(gains, np.float32)}
        elif stage == "isd":
            out[stage] = {"beta": np.float32(next(it)), "perm": next(it),
                          "f1": next(it), "f2": next(it)}
        else:
            noise = next(it)
            band, gain = notch()
            out[stage] = {"noise": noise, "band": band, "gain": gain,
                          "snr": np.float32(next(it))}
    assert next(it, None) is None
    return out


def _jax_reference(key, x, algo, lengths=None):
    """JAX's process_rawboost, un-jitted, on each utterance key that
    batch_rawboost splits from `key`: (outputs [B, L], the draws it made
    in the port's layout, as torch tensors)."""
    cfg = JRawBoostConfig(algo=algo)
    keys = jax.random.split(key, x.shape[0])
    ys, per_utt = [], []
    for b in range(x.shape[0]):
        with _recorded() as calls:
            length = None if lengths is None else jnp.int32(lengths[b])
            ys.append(np.asarray(JR.process_rawboost(
                keys[b], jnp.asarray(x[b]), cfg, length)))
        per_utt.append(_parse(calls, algo))
    draws = {s: {n: torch.from_numpy(np.stack([np.asarray(u[s][n])
                                               for u in per_utt]))
                 for n in per_utt[0][s]} for s in per_utt[0]}
    return np.stack(ys), draws


def _lengths_t(lengths):
    return None if lengths is None else torch.from_numpy(lengths).long()


# -------------------------------------------------------------- the pieces

@pytest.mark.parametrize(
    "c,f1,f2", [(11, 500.0, 1500.0), (51, 20.0, 120.0), (99, 6000.0, 7900.0)])
def test_firwin_bandstop_matches_jax(c, f1, f2):
    got = firwin_bandstop(torch.tensor([c]), torch.tensor([f1]),
                          torch.tensor([f2]), FS, MAX_TAPS)[0].numpy()
    want = np.asarray(JR.firwin_bandstop(jnp.int32(c), f1, f2, FS, MAX_TAPS))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(got[c:] == 0)


def _notch_inputs(seed=0, rows=4):
    rng = np.random.default_rng(seed)
    fcs = rng.uniform(CFG.minF, CFG.maxF, (rows, CFG.nBands))
    bws = rng.uniform(CFG.minBW, CFG.maxBW, (rows, CFG.nBands))
    cs = 2 * rng.integers(5, 51, (rows, CFG.nBands)) + 1
    cs[0] = [11, 25, 51, 75, 99]
    cs[1] = 101  # the longest cascade: nBands * max_taps - (nBands - 1)
    G = rng.uniform(-20.0, 0.0, rows)
    return (fcs.astype(np.float32), bws.astype(np.float32),
            cs.astype(np.int32), G.astype(np.float32))


def test_notch_from_draws_matches_jax():
    fcs, bws, cs, G = _notch_inputs()
    b, support = notch_from_draws(*map(torch.from_numpy, (fcs, bws, cs, G)),
                                  FS, MAX_TAPS, BANK_LEN)
    for r in range(fcs.shape[0]):
        jb, js = JR.notch_from_draws(
            jnp.asarray(fcs[r]), jnp.asarray(bws[r]), jnp.asarray(cs[r]),
            jnp.float32(G[r]), FS, MAX_TAPS, BANK_LEN)
        assert int(support[r]) == int(js) == int(cs[r].sum()) - 4
        np.testing.assert_allclose(b[r].numpy(), np.asarray(jb), atol=2e-6)
        assert np.all(b[r, int(js):].numpy() == 0)


@pytest.mark.parametrize("gains", [(0.0, 0.0), (-5.0, -20.0)],
                         ids=["lnl_first", "lnl_lowered"])
def test_gen_notch_coeffs_tap_counts_and_offsets_match_jax(gains):
    """On the uniforms JAX's gen_notch_coeffs draws: the same odd tap
    counts (JAX's own _rand_range on the same keys), the same support and
    crop offset exactly, the same cascade at 2e-6."""
    cfg = JRawBoostConfig()
    for seed in range(6):
        key = jax.random.PRNGKey(100 + seed)
        with _recorded() as calls:
            jb, js = JR.gen_notch_coeffs(key, cfg, *gains)
        band = torch.tensor(np.array(calls[:-1], np.float32)).reshape(
            CFG.nBands, 3)
        gain = torch.tensor(np.float32(calls[-1]))
        _, _, cs, _ = notch_draws(band, gain, CFG, *gains)
        keys = jax.random.split(key, 3 * CFG.nBands + 1)
        want_cs = []
        for i in range(CFG.nBands):
            c = int(jnp.floor(JR._rand_range(keys[3 * i + 2], cfg.minCoeff,
                                             cfg.maxCoeff)))
            want_cs.append(c + 1 if c % 2 == 0 else c)
        assert cs.tolist() == want_cs
        assert all(c % 2 == 1 and CFG.minCoeff <= c <= MAX_TAPS
                   for c in want_cs)
        b, support = gen_notch_coeffs(band, gain, CFG, *gains)
        assert int(support) == int(js)
        assert (int(support) + 1) // 2 == (int(js) + 1) // 2
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=2e-6)


@pytest.mark.parametrize("n", [4000, 997])
def test_fir_filter_centered_matches_jax(n):
    """Rows of different supports (so different crop offsets) through one
    batched call, against JAX's direct convolution and dynamic slice."""
    fcs, bws, cs, G = _notch_inputs(seed=1)
    b, support = notch_from_draws(*map(torch.from_numpy, (fcs, bws, cs, G)),
                                  FS, MAX_TAPS, BANK_LEN)
    x = _x(1, fcs.shape[0], n, scale=0.5)
    got = fir_filter_centered(torch.from_numpy(x), b, support).numpy()
    for r in range(x.shape[0]):
        want = np.asarray(JR.fir_filter_centered(
            jnp.asarray(x[r]), jnp.asarray(b[r].numpy()),
            jnp.int32(int(support[r]))))
        np.testing.assert_allclose(got[r], want, atol=1e-5)


@pytest.mark.parametrize("n,quantize", [(997, False), (4096, True),
                                        (20000, True)])
def test_n_smallest_mask_matches_jax_and_argsort(n, quantize):
    """Row by row, with forced float ties (37 distinct values), lanes
    pinned to 2.0 (the masked-lane convention) and n_sel in 0, 1, 7,
    n // 3, n: the JAX package's selection and the stable-argsort
    definition, exactly."""
    rng = np.random.default_rng(0)
    sels = [0, 1, 7, n // 3, n]
    u = rng.uniform(size=(len(sels), n)).astype(np.float32)
    if quantize:
        u = (np.floor(u * 37) / 37).astype(np.float32)
    for row in u:
        row[rng.choice(n, n // 10, replace=False)] = 2.0
    got = _n_smallest_mask(torch.from_numpy(u),
                           torch.tensor(sels, dtype=torch.int32)).numpy()
    for r, n_sel in enumerate(sels):
        ranks = np.argsort(np.argsort(u[r], kind="stable"), kind="stable")
        want = np.asarray(JR._n_smallest_mask(jnp.asarray(u[r]),
                                              jnp.int32(n_sel)))
        assert np.array_equal(got[r], want), (n, quantize, n_sel)
        assert np.array_equal(got[r], ranks < n_sel)


def test_norm_wav_matches_jax():
    x = np.array([[0.5, -2.0, 1.0, 0.0], [0.5, -0.25, 0.1, 3.0]], np.float32)
    lengths = np.array([3, 2])
    for always in (False, True):
        got = norm_wav(torch.from_numpy(x), always,
                       torch.from_numpy(lengths)).numpy()
        for r in range(2):
            want = JR.norm_wav(jnp.asarray(x[r]), always,
                               jnp.int32(lengths[r]))
            np.testing.assert_array_equal(got[r], np.asarray(want))


# ------------------------------------------------------- algos 1-8 vs JAX

@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("algo", range(1, 9))
def test_process_rawboost_matches_jax_on_its_draws(algo, masked):
    """Every algo, on the uniforms and normals JAX drew: outputs at ATOL,
    and where ISD runs its subset size and mask exactly (JAX's own
    _n_smallest_mask on the same uniforms)."""
    x = _x(algo)
    lengths = LENGTHS if masked else None
    want, draws = _jax_reference(jax.random.PRNGKey(algo), x, algo, lengths)
    cfg = RawBoostConfig(algo=algo)
    got = process_rawboost(torch.from_numpy(x), draws, cfg,
                           _lengths_t(lengths)).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL)
    if "isd" in draws:
        n_sel, sel = isd_selection(draws["isd"], cfg, L, _lengths_t(lengths))
        for b in range(B):
            n_valid = float(L if lengths is None else lengths[b])
            beta = 0.0 + (float(cfg.P) - 0.0) * jnp.float32(
                draws["isd"]["beta"][b].item())
            j_sel = int(jnp.floor(jnp.float32(n_valid) * beta / 100.0))
            u = draws["isd"]["perm"][b].numpy()
            if lengths is not None:
                u = np.where(np.arange(L) < lengths[b], u, 2.0)
            mask = np.asarray(JR._n_smallest_mask(jnp.asarray(u),
                                                  jnp.int32(j_sel)))
            assert int(n_sel[b]) == j_sel == int(mask.sum())
            assert np.array_equal(sel[b].numpy(), mask)


@pytest.mark.parametrize("algo,masked", [(4, True), (7, False)])
def test_batch_matches_jitted_jax_batch_rawboost(algo, masked):
    """JAX's jitted, vmapped batch_rawboost on the same key: the draws of
    its un-jitted utterances, through the port's batch, give its output."""
    x = _x(10 + algo)
    lengths = LENGTHS if masked else None
    key = jax.random.PRNGKey(10 + algo)
    _, draws = _jax_reference(key, x, algo, lengths)
    want = np.asarray(JR.batch_rawboost(
        key, jnp.asarray(x), JRawBoostConfig(algo=algo),
        None if lengths is None else jnp.asarray(lengths)))
    got = process_rawboost(torch.from_numpy(x), draws,
                           RawBoostConfig(algo=algo),
                           _lengths_t(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_algo_zero_is_the_identity_and_unknown_algos_raise():
    x = torch.from_numpy(_x())
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    assert batch_rawboost(gen, x, RawBoostConfig(algo=0)) is x
    assert torch.equal(gen.get_state(), state)  # nothing drawn
    with pytest.raises(ValueError, match="0-8"):
        process_rawboost(x, {}, RawBoostConfig(algo=9))


# -------------------------------------------------------- the torch draws

def test_draws_shapes_ranges_and_reproducibility():
    cfg = RawBoostConfig(algo=4)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    d = draw_rawboost(cfg, 3, 500, gen)
    again = draw_rawboost(cfg, 3, 500, torch.Generator().set_state(state))
    assert set(d) == {"lnl", "isd", "ssi"}
    shapes = {("lnl", "band"): (3, 5, 5, 3), ("lnl", "gain"): (3, 5),
              ("isd", "beta"): (3,), ("isd", "perm"): (3, 500),
              ("isd", "f1"): (3, 500), ("isd", "f2"): (3, 500),
              ("ssi", "noise"): (3, 500), ("ssi", "band"): (3, 5, 3),
              ("ssi", "gain"): (3,), ("ssi", "snr"): (3,)}
    for (stage, name), shape in shapes.items():
        t = d[stage][name]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert torch.equal(t, again[stage][name])
        if name != "noise":
            assert float(t.min()) >= 0.0 and float(t.max()) < 1.0
    assert set(draw_rawboost(RawBoostConfig(algo=7), 2, 9, gen)) == {
        "isd", "ssi"}
    # mapped ranges: odd tap counts in [minCoeff, maxCoeff + 1], LnL gains
    # in [minG, maxG] for the first power and lowered by the bias after it
    many = draw_rawboost(RawBoostConfig(algo=1), 400, 8, gen)["lnl"]
    lo = torch.tensor([0.0, -5.0, -5.0, -5.0, -5.0])
    hi = torch.tensor([0.0, -20.0, -20.0, -20.0, -20.0])
    fcs, bws, cs, G = notch_draws(many["band"], many["gain"], CFG, lo, hi)
    assert bool((cs % 2 == 1).all())
    assert int(cs.min()) >= CFG.minCoeff and int(cs.max()) <= MAX_TAPS
    assert float(fcs.min()) >= CFG.minF and float(fcs.max()) < CFG.maxF
    assert float(bws.min()) >= CFG.minBW and float(bws.max()) < CFG.maxBW
    assert bool((G[:, 0] == 0).all())
    assert float(G[:, 1:].max()) <= -5.0 and float(G[:, 1:].min()) > -20.0


def test_lnl_output_statistics():
    """tests/test_rawboost.py's LnL check on the port's own draws."""
    rng = np.random.default_rng(2)
    x = (0.5 * np.sin(2 * np.pi * 440 / FS * np.arange(8000))
         + 0.05 * rng.normal(size=8000)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    y = batch_rawboost(gen, torch.from_numpy(np.stack([x, x])),
                       RawBoostConfig(algo=1)).numpy()
    assert y.shape == (2, 8000) and np.all(np.isfinite(y))
    assert np.max(np.abs(y)) <= 1.0 + 1e-5
    assert np.all(np.abs(y.mean(axis=1)) < 1e-4)  # demeaned
    for row in y:  # still correlated with the clean signal
        assert np.corrcoef(x, row)[0, 1] > 0.4


def test_isd_changes_exactly_n_sel_samples():
    x = _x(3, 4, 20000, scale=0.05)
    cfg = RawBoostConfig(algo=2)
    gen = torch.Generator().manual_seed(3)
    draws = draw_rawboost(cfg, 4, 20000, gen)
    y = process_rawboost(torch.from_numpy(x), draws, cfg).numpy()
    n_sel, sel = isd_selection(draws["isd"], cfg, 20000)
    # no row's peak exceeds 1 here, so nothing is renormalised
    changed = y != x
    assert np.array_equal(changed, sel.numpy() & (
        draws["isd"]["f1"].numpy() != 0.5) & (draws["isd"]["f2"].numpy()
                                              != 0.5))
    assert np.array_equal(changed.sum(axis=1), n_sel.numpy())
    assert np.all(changed.mean(axis=1) <= cfg.P / 100.0)


def test_ssi_snr_within_range():
    x = (0.3 * np.sin(2 * np.pi * 300 / FS * np.arange(16000))).astype(
        np.float32)
    cfg = RawBoostConfig(algo=3)
    y = batch_rawboost(torch.Generator().manual_seed(4),
                       torch.from_numpy(np.stack([x] * 4)), cfg).numpy()
    for row in y:
        snr = 20 * np.log10(np.linalg.norm(x) / np.linalg.norm(row - x))
        assert cfg.SNRmin - 0.5 <= snr <= cfg.SNRmax + 0.5


@pytest.mark.parametrize("algo", range(1, 9))
def test_masked_batch_matches_unpadded(algo):
    """A zero-padded buffer with valid lengths equals the unpadded signal
    under the same draws (the per-sample draws cut to the signal), and is
    zero past the length; tests/test_rawboost.py:176-198 compares only
    statistics for ISD, whose subset here is the same set."""
    n, pad = 3000, 4096
    cfg = RawBoostConfig(algo=algo)
    x = _x(5, 2, n)
    buf = np.zeros((2, pad), np.float32)
    buf[:, :n] = x
    buf[1, n // 2:] = 0.0
    lengths = torch.tensor([n, n // 2])
    draws = draw_rawboost(cfg, 2, pad, torch.Generator().manual_seed(algo))
    padded = process_rawboost(torch.from_numpy(buf), draws, cfg,
                              lengths).numpy()
    for r, m in enumerate((n, n // 2)):
        cut = {s: {k: (v[r:r + 1, :m] if v.dim() == 2 and v.shape[1] == pad
                       else v[r:r + 1]) for k, v in d.items()}
               for s, d in draws.items()}
        short = process_rawboost(torch.from_numpy(buf[r:r + 1, :m]), cut,
                                 cfg).numpy()[0]
        np.testing.assert_allclose(padded[r, :m], short, atol=2e-5)
        assert np.all(padded[r, m:] == 0)
