"""HTTP scoring front-end over the one-class serving stack (port of
`occm_tpu.serve_http`: the same endpoints, body formats and limits).

Endpoints:
  GET  /healthz  -> {"status": "ok", "requests": N, "scored": N}
  POST /score    -> {"score": d, "prediction": 0|1, "label": ...}
      body: WAV bytes ("RIFF"), FLAC bytes ("fLaC"), or raw little-endian
      float32 mono PCM (anything else; sample rate via X-Sample-Rate
      header, default 16000). Audio at other rates is resampled to 16 kHz.

Bodies above SPOOL_THRESHOLD_BYTES are streamed to a spool file in chunks
and decoded from it by the native readers (`io.native`): FLAC frame by
frame through `FlacStream`, WAV by the native file reader, each held to
MAX_DECODED_SAMPLES. Where the native library is unavailable they are
decoded in memory by the Python decoders, as the JAX server does then.

Stdlib-only (ThreadingHTTPServer): each connection runs on its own thread
and blocks in BatchingQueue.score_sync while the batcher groups concurrent
utterances into one device call.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from occm_tpu_torch.io.flac import decode_flac
from occm_tpu_torch.io.wav import _parse_wav, resample

TARGET_SR = 16000
MAX_BODY_BYTES = 1024 * 1024 * 1024  # sanity cap; large bodies are spooled
# bodies above this are streamed to a spool file in chunks and decoded by
# the native readers: the handler never holds the encoded body in memory
SPOOL_THRESHOLD_BYTES = 8 * 1024 * 1024
_CHUNK = 1 << 16
# the DECODED wave must be bounded too: spooling keeps encoded bytes off
# the heap, but a 1 GB FLAC still expands to several GB of float32, and
# ThreadingHTTPServer handles requests concurrently. 64M input samples
# (~22 min at 48 kHz) x 4 B = 256 MB per request, and at most
# _MAX_CONCURRENT_SPOOL_DECODES large-body decodes run at once.
MAX_DECODED_SAMPLES = 64 * 1024 * 1024
_MAX_CONCURRENT_SPOOL_DECODES = 2
_spool_decode_slots = threading.Semaphore(_MAX_CONCURRENT_SPOOL_DECODES)


def decode_request_audio(body: bytes, sample_rate_header: Optional[str]
                         ) -> np.ndarray:
    """Bytes -> float32 mono wave at 16 kHz. Container detected by magic
    bytes; bare bodies are raw little-endian float32 PCM."""
    if body[:4] == b"RIFF":
        wave, sr = _parse_wav(body)
    elif body[:4] == b"fLaC":
        samples, sr, bps = decode_flac(body)
        wave = samples.astype(np.float32) / float(1 << (bps - 1))
        wave = wave.mean(axis=1) if wave.shape[1] > 1 else wave[:, 0]
    else:
        if len(body) % 4:
            raise ValueError(
                "raw PCM body length not a multiple of 4 (float32)"
            )
        wave = np.frombuffer(body, dtype="<f4").astype(np.float32)
        sr = int(sample_rate_header) if sample_rate_header else TARGET_SR
    if len(wave) == 0:
        raise ValueError("empty audio")
    if len(wave) > MAX_DECODED_SAMPLES:
        raise ValueError(
            f"audio too long: {len(wave)} samples (cap {MAX_DECODED_SAMPLES})"
        )
    return resample(np.ascontiguousarray(wave), sr, TARGET_SR)


def _stream_flac(path: str) -> Tuple[np.ndarray, int]:
    """A FLAC file through the native streaming decoder, in chunks of
    1 << 20 samples, held to MAX_DECODED_SAMPLES by STREAMINFO and again
    while reading (for a header that says 0 samples, or lies)."""
    from occm_tpu_torch.io import native

    with native.FlacStream(path) as stream:
        if stream.total_samples > MAX_DECODED_SAMPLES:
            raise ValueError(f"audio too long: {stream.total_samples} "
                             f"samples (cap {MAX_DECODED_SAMPLES})")
        parts, total = [], 0
        while True:
            chunk = stream.read(1 << 20)
            if len(chunk) == 0:
                break
            total += len(chunk)
            if total > MAX_DECODED_SAMPLES:
                raise ValueError(
                    f"audio too long: >{MAX_DECODED_SAMPLES} samples")
            parts.append(chunk)
        wave = np.concatenate(parts) if parts else np.empty(0, np.float32)
        return wave, stream.sample_rate


def decode_spooled_audio(path: str, sample_rate_header: Optional[str]
                         ) -> np.ndarray:
    """Decode a spooled request body from disk -> float32 mono @16 kHz.

    FLAC streams through the native decoder (constant decoder memory, so a
    long recording costs one float32 wave), WAV goes through the native
    file reader; without the native library both are decoded in memory
    by `decode_request_audio`. Raw float32 PCM is read from the file."""
    from occm_tpu_torch.io import native

    with open(path, "rb") as f:
        magic = f.read(4)
    if magic in (b"fLaC", b"RIFF") and not native.available():
        with open(path, "rb") as f:
            return decode_request_audio(f.read(), sample_rate_header)
    if magic == b"fLaC":
        wave, sr = _stream_flac(path)
    elif magic == b"RIFF":
        wave, sr = native.native_read_wav(path)
        if len(wave) > MAX_DECODED_SAMPLES:
            raise ValueError(f"audio too long: {len(wave)} samples "
                             f"(cap {MAX_DECODED_SAMPLES})")
    else:  # raw float32 PCM
        if os.path.getsize(path) % 4:
            raise ValueError(
                "raw PCM body length not a multiple of 4 (float32)")
        if os.path.getsize(path) // 4 > MAX_DECODED_SAMPLES:
            raise ValueError(
                f"audio too long: {os.path.getsize(path) // 4} samples "
                f"(cap {MAX_DECODED_SAMPLES})")
        wave = np.fromfile(path, dtype="<f4").astype(np.float32)
        sr = int(sample_rate_header) if sample_rate_header else TARGET_SR
    if len(wave) == 0:
        raise ValueError("empty audio")
    return resample(np.ascontiguousarray(wave), sr, TARGET_SR)


class _Handler(BaseHTTPRequestHandler):
    # set by ScoringHTTPServer subclassing
    server_ref: "ScoringHTTPServer"

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        if self.server_ref.verbose:
            super().log_message(fmt, *args)

    def do_GET(self):
        if self.path in ("/healthz", "/health"):
            s = self.server_ref
            self._json(200, {"status": "ok", "requests": s.requests,
                             "scored": s.scored})
        else:
            self._json(404, {"error": f"no such path {self.path}"})

    def do_POST(self):
        s = self.server_ref
        s.count("requests")
        if self.path != "/score":
            self._json(404, {"error": f"no such path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._json(400, {"error": "bad Content-Length"})
            return
        if length <= 0:
            self._json(400, {"error": "empty body"})
            return
        if length > MAX_BODY_BYTES:
            self._json(413, {"error": "body too large"})
            return
        sr_header = self.headers.get("X-Sample-Rate")
        try:
            if length > SPOOL_THRESHOLD_BYTES:
                # stream the body to a spool file in chunks, then decode
                # it. The unlink covers the WRITE phase too: an aborted
                # upload must not orphan a partially-written spool file
                tmp = tempfile.NamedTemporaryFile(
                    suffix=".spool", delete=False
                )
                spool_path = tmp.name
                try:
                    with tmp:
                        remaining = length
                        while remaining:
                            chunk = self.rfile.read(min(_CHUNK, remaining))
                            if not chunk:
                                raise ValueError("truncated body")
                            tmp.write(chunk)
                            remaining -= len(chunk)
                    # bound concurrent large-body decodes (each may hold
                    # up to MAX_DECODED_SAMPLES*4 bytes of decoded wave)
                    with _spool_decode_slots:
                        wave = decode_spooled_audio(spool_path, sr_header)
                finally:
                    os.unlink(spool_path)
            else:
                wave = decode_request_audio(self.rfile.read(length),
                                            sr_header)
        except Exception as e:
            self._json(400, {"error": f"undecodable audio: {e}"})
            return
        try:
            score, pred = s.batcher.score_sync(wave, timeout=s.timeout_s)
        except Exception as e:
            self._json(500, {"error": f"scoring failed: {e}"})
            return
        s.count("scored")
        # decision-rule parity: distance > threshold -> 1 (spoof); the
        # PFDataset label convention is bona=0/spoof=1
        # (reference: oc_classifier.py:262, oc_training.py:225)
        self._json(200, {
            "score": score,
            "prediction": pred,
            "label": "spoof" if pred else "bonafide",
        })


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of more
    # concurrent connections than that (a batch of 8 requests) overflows
    # it and the kernel drops SYNs, which the clients retransmit only
    # after a delay; the late requests then miss the batching window
    request_queue_size = 128


class ScoringHTTPServer:
    """Threaded HTTP server wrapping a BatchingQueue (or any object with
    `score_sync(wave, timeout) -> (score, pred)`).

    port=0 binds an ephemeral port (read `.port` after construction)."""

    def __init__(self, batcher, host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 60.0, verbose: bool = False):
        self.batcher = batcher
        self.timeout_s = timeout_s
        self.verbose = verbose
        # handler threads are concurrent; += on an attribute is not atomic
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.scored = 0

        outer = self

        class BoundHandler(_Handler):
            server_ref = outer

        self._httpd = _Server((host, port), BoundHandler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    def count(self, name: str) -> None:
        with self._stats_lock:
            setattr(self, name, getattr(self, name) + 1)

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ScoringHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join()

    def __enter__(self) -> "ScoringHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
