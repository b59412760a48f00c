"""The port's serving stack (`occm_tpu_torch.serve`, `serve_http`,
`cli.oc_server`) on the CPU, against the JAX `ScoringService` on the same
weights and reference embedding.

The Flax AModel (full AASIST backend, tiny XLSR, every parameter and
BatchNorm statistic perturbed) is exported to a reference-named torch file
with `export_amodel_state_dict`, the file `--pretrained-sslaasist` takes.
Scores agree within 1e-4 relative: both sides run fp32 at tiny width, and
only summation order differs.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import wave as wave_mod

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.convert_backend import export_amodel_state_dict
from occm_tpu.serve import ScoringService as JScoringService
from occm_tpu.serve import make_score_fn as jmake_score_fn
from occm_tpu_torch.cli import oc_server
from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.io.flac import encode_flac_mono16
from occm_tpu_torch.models import AModel, state_dict_from_flax
from occm_tpu_torch.serve import BatchingQueue, ScoringService, make_score_fn
from occm_tpu_torch.serve_http import ScoringHTTPServer, decode_request_audio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = 3200
RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_side():
    """(variables as numpy, JAX ScoringService, reference, threshold)."""
    model = JAModel(JAASISTConfig(), xlsr_cfg=JXLSRConfig.tiny())
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda x: model.init(
        {"params": key, "dropout": key}, x))(jnp.zeros((2, CUT)))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    reference = rng.normal(size=160).astype(np.float32)
    threshold = 12.0
    fn = jmake_score_fn(model, variables["params"], variables["batch_stats"])
    service = JScoringService(fn, reference, threshold=threshold,
                              buckets=(CUT,), batch=2)
    return variables, service, reference, threshold


def _waves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n) * 0.1).astype(np.float32) for n in lengths]


def _wav_bytes(wave: np.ndarray, sr: int = 16000) -> bytes:
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _flac_bytes(wave: np.ndarray, sr: int = 16000) -> bytes:
    return encode_flac_mono16(
        (np.clip(wave, -1, 1) * 32767).astype(np.int64), sr)


def _post(url: str, body: bytes, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _port_service(variables, reference, threshold, **kw):
    model = AModel(AASISTConfig(), XLSRConfig.tiny())
    model.load_state_dict(state_dict_from_flax(variables, XLSRConfig.tiny()),
                          strict=True)
    return ScoringService(score_fn=make_score_fn(model, "xla"),
                          reference_embedding=reference, threshold=threshold,
                          device="cpu", **kw)


def test_service_scores_match_jax(jax_side):
    """Several utterances, batches of 2 with a ragged tail, a bucket opened
    past the largest one: same distances and decisions as JAX."""
    variables, jservice, reference, threshold = jax_side
    waves = _waves(1, [2500, 3200, 1000, 2900, 7000])
    want, want_pred = jservice.score(waves)
    svc = _port_service(variables, reference, threshold, buckets=(CUT,),
                        batch=2)
    got, pred = svc.score(waves)
    assert svc.buckets == [CUT, 3 * CUT] == jservice.buckets
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_array_equal(pred, want_pred)
    np.testing.assert_array_equal(pred, (got > threshold).astype(np.int32))


def test_batching_queue_and_http_server(jax_side):
    """WAV, FLAC and raw-PCM bodies sent concurrently through the port's
    BatchingQueue and HTTP front-end score as the JAX service scores the
    same decoded audio; the error paths answer as the JAX server does."""
    variables, jservice, reference, threshold = jax_side
    svc = _port_service(variables, reference, threshold, buckets=(CUT,),
                        batch=2)
    (wave,) = _waves(2, [2500])
    bodies = [_wav_bytes(wave), _flac_bytes(wave),
              wave.astype("<f4").tobytes()]
    with BatchingQueue(svc, max_wait_ms=50.0) as batcher:
        with ScoringHTTPServer(batcher) as server:
            base = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                assert json.loads(r.read())["status"] == "ok"
            results = [None] * len(bodies)

            def worker(i):
                results[i] = _post(base + "/score", bodies[i])

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert _post(base + "/score", b"\x01\x02\x03")[0] == 400
            assert _post(base + "/nope", b"RIFF")[0] == 404
            assert server.scored == 3

    want, want_pred = jservice.score(
        [decode_request_audio(b, None) for b in bodies])
    for (code, payload), w, p in zip(results, want, want_pred):
        assert code == 200
        assert payload["label"] == ("spoof" if p else "bonafide")
        assert payload["prediction"] == p
        np.testing.assert_allclose(payload["score"], w, rtol=RTOL)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_oc_server_cli_serves_exported_checkpoint(jax_side, tmp_path, impl):
    """`oc_server --device cpu` with a file written by the JAX exporter
    (which drops all-zero conv biases) serves the JAX scores."""
    variables, jservice, reference, threshold = jax_side
    exported = export_amodel_state_dict(variables, JXLSRConfig.tiny())
    ckpt = tmp_path / "amodel.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
               ckpt)
    np.save(tmp_path / "reference_embedding.npy", reference)
    np.save(tmp_path / "threshold.npy", np.float32(threshold))

    started = threading.Event()
    started.stop = threading.Event()
    t = threading.Thread(target=oc_server.main, args=([
        "--pretrained-sslaasist", str(ckpt), "--artifacts_dir", str(tmp_path),
        "--host", "127.0.0.1", "--port", "0", "--xlsr_tiny",
        "--batch_size", "2", "--buckets", str(CUT), "--device", "cpu",
        "--attention_impl", impl], started), daemon=True)
    t.start()
    assert started.wait(timeout=120), "server failed to start"
    try:
        waves = _waves(3, [2000, 3100])
        got = [_post(f"http://127.0.0.1:{started.server.port}/score",
                     w.astype("<f4").tobytes()) for w in waves]
    finally:
        started.stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    want, _ = jservice.score(waves)
    for (code, payload), w in zip(got, want):
        assert code == 200
        np.testing.assert_allclose(payload["score"], w, rtol=RTOL)


@pytest.mark.parametrize("flag", ["--data_parallel"])
def test_oc_server_unported_flags_raise(tmp_path, flag):
    argv = ["--artifacts_dir", str(tmp_path), "--xlsr_tiny",
            "--allow_random_init", "--device", "cpu", flag]
    if flag == "--data_parallel":
        # ported (ROADMAP item 15a): 2 devices on the CPU, which is one,
        # raise as JAX's make_dp_mesh does
        argv.append("2")
    with pytest.raises(ValueError, match="only 1 present"):
        oc_server.main(argv)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Entry points run on CUDA unless the caller asks for the CPU; with no
    card they raise rather than drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringService(score_fn=lambda x: (x, x),
                       reference_embedding=np.zeros(4, np.float32))
    np.save(tmp_path / "reference_embedding.npy", np.zeros(160, np.float32))
    np.save(tmp_path / "threshold.npy", np.float32(1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oc_server.main(["--artifacts_dir", str(tmp_path), "--xlsr_tiny",
                        "--allow_random_init"])


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, loads no
    jax, flax or occm_tpu module, and none of orbax's (orbax, tensorstore,
    zstandard): the port reads and writes orbax directories itself."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import occm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    occm_tpu_torch.__path__, 'occm_tpu_torch.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'occm_tpu', 'orbax',\n"
        "              'tensorstore', 'zstandard'))\n"
        "assert len(names) > 20, names\n"
        "print('BAD', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
