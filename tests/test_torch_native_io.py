"""The port's native IO lane (`occm_tpu_torch.io.native`, the library built
from native/*.cpp by the port itself) against its Python decoders and
against the JAX package's native lane on the same files: the readers bit
for bit, the threaded batch decode's repeat-pad and crop, the header length
probes, streamed and ranged FLAC, the spooled request decode and its cap,
`embed_paths` and the training pipeline's native epoch, the fallback of
every caller when the library is unavailable, and concurrent builds."""

import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from occm_tpu.classify import BucketedEmbedder as JBucketedEmbedder
from occm_tpu.data import MetaBatchPipeline as JMetaBatchPipeline
from occm_tpu.data import PFDataset as JPFDataset
from occm_tpu.io import native as jnative

from occm_tpu_torch import serve_http
from occm_tpu_torch.audio import pad_numpy
from occm_tpu_torch.classify import BucketedEmbedder
from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
from occm_tpu_torch.data.sampler import VOCODER_NAMES
from occm_tpu_torch.io import native
from occm_tpu_torch.io.flac import encode_flac
from occm_tpu_torch.io.wav import _read_python, load_audio

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav(path, pcm: bytes, fmt: int, bits: int, sr: int = SR) -> None:
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, 1, sr,
                                 sr * bits // 8, bits // 8, bits)
    with open(path, "wb") as f:
        f.write(hdr + b"data" + struct.pack("<I", len(pcm)) + pcm)


def _flac(path, x: np.ndarray, bps: int, zero_total: bool = False) -> None:
    data = bytearray(encode_flac(np.round(x * (2 ** (bps - 1) - 1)), SR,
                                 bps=bps, block_size=1024))
    if zero_total:  # STREAMINFO's 36-bit total sample count set to 0
        data[21] &= 0xF0
        data[22:26] = b"\0\0\0\0"
    with open(path, "wb") as f:
        f.write(bytes(data))


def _write(path, kind: str, x: np.ndarray) -> str:
    path = str(path)
    if kind == "wav16":
        _wav(path, (x * 32767).astype("<i2").tobytes(), 1, 16)
    elif kind == "wav24":
        v = (x * 8388607).astype("<i4").view(np.uint8).reshape(-1, 4)
        _wav(path, v[:, :3].tobytes(), 1, 24)
    elif kind == "wav32":
        _wav(path, (x * 2147483000).astype("<i4").tobytes(), 1, 32)
    elif kind == "wavf32":
        _wav(path, x.astype("<f4").tobytes(), 3, 32)
    else:  # flac16, flac24, flac16_nototal
        _flac(path, x, int(kind[4:6]), zero_total=kind.endswith("nototal"))
    return path


def _name(stem, kind: str) -> str:
    return f"{stem}.{'flac' if kind.startswith('flac') else 'wav'}"


KINDS = ("wav16", "wav24", "wav32", "wavf32", "flac16", "flac24")


def _wave(rng, n):
    return np.clip(0.3 * rng.normal(size=n), -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One file of each kind, of a length each, and a FLAC whose
    STREAMINFO does not give its length."""
    root = tmp_path_factory.mktemp("native_io")
    rng = np.random.default_rng(0)
    # short 24-bit FLAC: the Python decoder takes ~0.5 ms a sample there
    lens = (1500, 2200, 2900, 3600, 2600, 700, 1900)
    return {kind: _write(root / _name(kind, kind), kind, _wave(rng, n))
            for kind, n in zip(KINDS + ("flac16_nototal",), lens)}


def test_library_is_the_ports_own_build():
    path = native.build()
    assert path.startswith(native.BUILD_DIR)
    assert native.available()
    assert os.path.basename(path) != "libocmio.so"


@pytest.mark.parametrize("kind", KINDS + ("flac16_nototal",))
def test_native_reader_equals_python_and_jax(files, kind):
    got, sr = native.native_read_wav(files[kind])
    want, want_sr = _read_python(files[kind])
    assert sr == want_sr == SR and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    jgot, jsr = jnative.native_read_wav(files[kind])
    assert jsr == sr
    np.testing.assert_array_equal(got, jgot)
    wave, _ = load_audio(files[kind])
    np.testing.assert_array_equal(wave, want)


@pytest.mark.parametrize("max_len", [1000, 9000])  # crop, repeat-pad
def test_batch_padded_repeats_and_crops(files, max_len):
    paths = [files[k] for k in KINDS]
    out, valid, srs = native.native_read_batch_padded(paths, max_len,
                                                      n_threads=3)
    assert out.shape == (len(paths), max_len) and out.dtype == np.float32
    for row, n, sr, p in zip(out, valid, srs, paths):
        want, _ = _read_python(p)
        assert (n, sr) == (len(want), SR)
        np.testing.assert_array_equal(row, pad_numpy(want, max_len))
    jout, jvalid, _ = jnative.native_read_batch_padded(paths, max_len)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(valid, jvalid)


def test_audio_len_batch_equals_decoded_lengths(files, tmp_path):
    paths = [files[k] for k in KINDS + ("flac16_nototal",)]
    paths.append(str(tmp_path / "missing.wav"))
    lens, srs = native.native_audio_len_batch(paths, n_threads=4)
    for p, n, sr in zip(paths[:len(KINDS)], lens, srs):
        assert (n, sr) == (len(_read_python(p)[0]), SR)
        assert native.native_audio_len(p) == (n, sr)
    assert lens[-2] == lens[-1] == -1  # no length in STREAMINFO; missing
    with pytest.raises(IOError):
        native.native_audio_len(paths[-2])


@pytest.mark.parametrize("kind", ["flac16", "flac24", "flac16_nototal"])
def test_flac_stream_and_ranges(files, kind):
    path = files[kind]
    whole, _ = _read_python(path)
    with native.FlacStream(path) as stream:
        assert stream.sample_rate == SR
        assert stream.total_samples == (0 if "nototal" in kind
                                        else len(whole))
        chunks = [stream.read(1000)]
        while len(chunks[-1]):
            chunks.append(stream.read(1000))
    assert all(len(c) == 1000 for c in chunks[:-2])
    np.testing.assert_array_equal(np.concatenate(chunks), whole)
    for start, count in ((0, 10), (1023, 2), (500, 5000), (len(whole), 9)):
        got, sr = native.native_read_flac_range(path, start, count)
        np.testing.assert_array_equal(got, whole[start:start + count])
        got2, _ = native.native_read_audio_range(path, start, count)
        np.testing.assert_array_equal(got2, got)
    samples, offsets = native.flac_seek_points(path)  # no SEEKTABLE
    assert samples.shape == offsets.shape == (0,)
    native.set_flac_crc_verify(False)
    try:
        np.testing.assert_array_equal(native.native_read_wav(path)[0], whole)
    finally:
        native.set_flac_crc_verify(True)


def test_wav_range_reads_are_slices(files):
    whole, _ = _read_python(files["wav24"])
    got, sr = native.native_read_audio_range(files["wav24"], 100, 777)
    assert sr == SR
    np.testing.assert_array_equal(got, whole[100:877])


@pytest.mark.parametrize("kind", ["flac16", "flac16_nototal", "wav16",
                                  "wavf32"])
def test_decode_spooled_audio_equals_python(files, kind):
    native.reset_counts()
    got = serve_http.decode_spooled_audio(files[kind], None)
    assert native.CALLS["flac_read" if "flac" in kind else "read_wav"] > 0
    with open(files[kind], "rb") as f:
        want = serve_http.decode_request_audio(f.read(), None)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["flac16", "flac16_nototal", "wav16"])
def test_decode_spooled_audio_holds_the_cap(files, kind, monkeypatch):
    """A body over MAX_DECODED_SAMPLES raises: from STREAMINFO, and for a
    STREAMINFO that says 0, while reading."""
    monkeypatch.setattr(serve_http, "MAX_DECODED_SAMPLES", 1200)
    native.reset_counts()
    with pytest.raises(ValueError, match="audio too long"):
        serve_http.decode_spooled_audio(files[kind], None)
    assert native.CALLS["flac_read"] == (1 if kind == "flac16_nototal"
                                         else 0)


def _toy(x):
    """A stand-in model whose outputs are exact in any framework (maxima
    and minima, no sums), and which sees every sample of the batch."""
    b = x.shape[0]
    parts = x.reshape(b, 8, -1)
    emb = torch.cat([parts.amax(-1), parts.amin(-1)], 1)
    return emb, torch.stack([x.amax(-1), x.amin(-1)], 1)


def _jax_toy(x):
    import jax.numpy as jnp

    parts = x.reshape(x.shape[0], 8, -1)
    emb = jnp.concatenate([parts.max(-1), parts.min(-1)], 1)
    return emb, jnp.stack([x.max(-1), x.min(-1)], 1)


@pytest.fixture(scope="module")
def eval_files(tmp_path_factory):
    """WAV and FLAC utterances over several 3200-sample buckets, one
    longer than max_len, one FLAC without its length in STREAMINFO."""
    root = tmp_path_factory.mktemp("native_eval")
    rng = np.random.default_rng(3)
    kinds = ("wav16", "flac16", "wav24", "flac16_nototal", "wavf32",
             "wav16", "wav16", "flac16", "wav32")
    lens = (1700, 3000, 3201, 6400, 9900, 12100, 800, 5000, 4000)
    return [_write(root / _name(f"u{i}", k), k, _wave(rng, n))
            for i, (k, n) in enumerate(zip(kinds, lens))]


@pytest.mark.parametrize("max_len", [None, 9600])
def test_embed_paths_lanes_are_byte_identical(eval_files, max_len,
                                              monkeypatch):
    emb = BucketedEmbedder(_toy, bucket_step=3200, batch_size=3,
                           max_len=max_len, device="cpu", decode_threads=3)
    waves = [_read_python(p)[0] for p in eval_files]
    want = emb.embed_all(waves)
    native.reset_counts()
    got = emb.embed_paths(eval_files)
    assert native.CALLS["read_batch_padded"] == 4
    assert native.CALLS["audio_len_batch"] == 1
    assert native.CALLS["read_wav"] == 1  # the FLAC without a length
    jemb = JBucketedEmbedder(_jax_toy, bucket_step=3200, batch_size=3,
                             max_len=max_len)
    jwant = jemb.embed_paths(eval_files)
    monkeypatch.setattr(native, "available", lambda: False)
    native.reset_counts()
    off = emb.embed_paths(eval_files)
    assert not native.CALLS
    for a, b, c, d in zip(got, want, off, jwant):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, np.asarray(d))


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """7 bonafide rows (a ragged tail at G = 3), WAV and FLAC, and their
    vocoded copies."""
    root = tmp_path_factory.mktemp("native_train")
    train, voc = root / "train", root / "vocoded"
    train.mkdir()
    voc.mkdir()
    rng = np.random.default_rng(5)
    lines = []
    for i in range(7):
        utt = f"LA_T_b{i:04d}"
        kind = "flac16" if i % 2 else "wav16"
        _write(train / _name(utt, kind), kind, _wave(rng, 900 + 300 * i))
        for v in VOCODER_NAMES:
            _write(voc / _name(f"{v}_{utt}", kind), kind,
                   _wave(rng, 1000 + 7 * i))
        lines.append(f"LA_{i:04d} {utt} - - bonafide")
    for i in range(2):
        utt = f"LA_T_s{i:04d}"
        _write(train / f"{utt}.wav", "wav16", _wave(rng, 2500))
        lines.append(f"LA_{100 + i:04d} {utt} - A01 spoof")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return str(root / "train.txt"), str(train), str(voc)


def _epochs(pipeline, n=2):
    return [list(pipeline.epoch(e)) for e in range(n)]


@pytest.mark.parametrize("groups", [1, 3])
def test_pipeline_native_epoch_equals_per_item_and_jax(train_tree, groups,
                                                       monkeypatch):
    protocol, train, voc = train_tree
    kw = dict(groups_per_step=groups, seed=4)

    def port():
        return MetaBatchPipeline(
            PFDataset(protocol, train, voc, cut=4000, seed=4), **kw)

    pipe = port()
    assert pipe._native
    native.reset_counts()
    got = _epochs(pipe)
    assert native.CALLS["read_batch_padded"] == 2 * pipe.steps_per_epoch()
    jpipe = JMetaBatchPipeline(
        JPFDataset(protocol, train, voc, cut=4000, seed=4), shard_index=0,
        shard_count=1, **kw)
    want = _epochs(jpipe)
    monkeypatch.setattr(native, "available", lambda: False)
    per_item = port()
    assert not per_item._native
    off = _epochs(per_item)
    for epochs in (want, off):
        assert [len(e) for e in epochs] == [len(e) for e in got]
        for e_got, e_want in zip(got, epochs):
            for (x, y), (xw, yw) in zip(e_got, e_want):
                assert x.dtype == np.float32 and y.dtype == np.int64
                np.testing.assert_array_equal(x, xw)
                np.testing.assert_array_equal(y, yw)
    assert got[0][-1][0].shape[0] == 12 * (1 if groups == 1 else 7 % groups)


@pytest.mark.parametrize("caller", ["load_audio", "spooled", "embed_paths",
                                    "pipeline"])
def test_callers_fall_back_to_python(files, eval_files, train_tree, caller,
                                     monkeypatch):
    """With the library unavailable every caller decodes in Python, to the
    same results, and calls nothing native."""
    def run():
        if caller == "load_audio":
            return [load_audio(files[k])[0] for k in KINDS]
        if caller == "spooled":
            return [serve_http.decode_spooled_audio(files[k], None)
                    for k in ("flac24", "wav32")]
        if caller == "embed_paths":
            return list(BucketedEmbedder(
                _toy, bucket_step=3200, batch_size=4,
                device="cpu").embed_paths(eval_files))
        protocol, train, voc = train_tree
        return [x for x, _ in MetaBatchPipeline(PFDataset(
            protocol, train, voc, cut=3000)).epoch(0)]

    want = run()
    monkeypatch.setattr(native, "available", lambda: False)
    native.reset_counts()
    got = run()
    assert not native.CALLS
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_concurrent_builds_load_a_complete_library(tmp_path):
    """Two processes that build into one empty directory at once: both
    load a library that decodes."""
    wav = _write(tmp_path / "a.wav", "wav16",
                 _wave(np.random.default_rng(1), 1234))
    script = textwrap.dedent("""
        import ctypes, sys
        from occm_tpu_torch.io import native
        native.BUILD_DIR = sys.argv[1]
        lib = ctypes.CDLL(native.build())
        n, sr = ctypes.c_int64(), ctypes.c_int()
        assert lib.ocm_audio_len(sys.argv[2].encode(), ctypes.byref(n),
                                 ctypes.byref(sr)) == 0
        print(n.value, sr.value)
    """)
    build_dir = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, build_dir, wav],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["1234", str(SR)]
    built = [f for f in os.listdir(build_dir) if f.endswith(".so")]
    assert len(built) == 1
