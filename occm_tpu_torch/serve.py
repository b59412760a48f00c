"""One-class scoring service and dynamic batcher (port of `occm_tpu.serve`).

- `make_score_fn(model, attention_impl)` turns a model into
  wave [B, T] -> (emb, logits), run under `torch.inference_mode`.
- `ScoringService` pads each utterance into a length bucket, scores full
  batches on the device and applies the reference-embedding decision rule
  (score = ||emb - reference||2 with torch eps semantics, pred = score >
  threshold), with the same bucket, batch and padding rules as the JAX
  service.
- `BatchingQueue` groups concurrent single-utterance requests into one
  device call.

`ScoringService(mesh=)` scores data-parallel over a list of local devices
(`parallel/replicas.py`): each batch, rounded up to a multiple of the mesh
size, is split into one row block per device and the embeddings gathered
in order, as the JAX service shards its batch over a ("dp",) mesh.

The JAX service's `aot_compile` and `export_stablehlo` are XLA-only and
have no counterpart: PyTorch runs eagerly, and `warmup()` instead runs one
zero batch per bucket, which also builds the CUDA kernels.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from occm_tpu_torch.audio import pad_numpy
from occm_tpu_torch.losses import pairwise_distance
from occm_tpu_torch.parallel.replicas import as_dp_mesh, per_device, round_up
from occm_tpu_torch.utils.device import resolve_device


def make_score_fn(model: torch.nn.Module,
                  attention_impl: Optional[str] = None) -> Callable:
    """wave [B, T] tensor -> (emb [B, D], logits [B, C]); the model runs in
    eval mode. attention_impl overrides the model config's impl."""
    model.eval()

    def fn(x: torch.Tensor):
        with torch.inference_mode():
            return model(x, attention_impl=attention_impl)

    return fn


class ScoringService:
    """One-class scoring over per-bucket score functions.

    Decision rule parity: score = ||emb - reference||2 (torch eps
    semantics), pred = score > threshold (reference: oc_classifier.py:262).
    """

    def __init__(
        self,
        score_fn: Optional[Callable] = None,
        reference_embedding: np.ndarray = None,
        threshold: float = 0.0,
        buckets: Sequence[int] = (16000, 48000, 64600, 96000),
        batch: int = 8,
        score_fn_factory: Optional[Callable[[int], Callable]] = None,
        device="cuda",
        mesh=None,
    ):
        """score_fn_factory(bucket_samples) -> score_fn: per-bucket score
        functions (mutually exclusive with score_fn), the serving side of
        attention_impl="auto" (classify.impl_select).

        device: where batches and the reference live; "cuda" unless the
        caller asks for "cpu". Raises when CUDA is asked for and absent.

        mesh: an optional data-parallel mesh (`make_dp_mesh()` or a list of
        devices): `batch` is rounded up to a multiple of its size, each
        batch split over its devices, and a score fn is one callable per
        mesh device or one that runs where its input lies; the first mesh
        device takes the place of `device`."""
        if (score_fn is None) == (score_fn_factory is None):
            raise ValueError(
                "pass exactly one of score_fn / score_fn_factory")
        self.mesh = None
        if mesh is not None:
            self.mesh = as_dp_mesh(mesh)
            batch = round_up(batch, self.mesh)
            device = self.mesh.devices[0]
        self.device = resolve_device(device)
        self._fn = score_fn
        self._factory = score_fn_factory
        self.reference = torch.as_tensor(
            np.asarray(reference_embedding, np.float32), device=self.device)
        self.threshold = float(threshold)
        self.batch = batch
        self.buckets = sorted(buckets)
        self._fns: Dict[int, Callable] = {}

    def warmup(self) -> None:
        """One zero batch per bucket: builds the kernels and allocator
        pools before the first request."""
        for b in self.buckets:
            self._get(b)(torch.zeros((self.batch, b), dtype=torch.float32,
                                     device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _get(self, bucket: int) -> Callable:
        if bucket not in self._fns:
            fn = self._fn if self._factory is None else self._factory(bucket)
            if self.mesh is not None:
                fn = per_device(fn, self.mesh)
            self._fns[bucket] = fn
        return self._fns[bucket]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        # longer than every bucket: open a new one at the next multiple of
        # the smallest bucket rather than truncating — the reference scores
        # full-length audio (oc_classifier.py:93-94)
        step = self.buckets[0]
        b = ((n + step - 1) // step) * step
        if b not in self.buckets:
            self.buckets.append(b)
            self.buckets.sort()
        return b

    def score(self, waves: Sequence[np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances, predictions) for a list of waveforms."""
        out_scores = np.empty(len(waves), np.float64)
        by_bucket: Dict[int, list] = {}
        for i, w in enumerate(waves):
            by_bucket.setdefault(self._bucket_for(len(w)), []).append(i)
        for bucket, idxs in by_bucket.items():
            fn = self._get(bucket)
            for start in range(0, len(idxs), self.batch):
                chunk = idxs[start: start + self.batch]
                batch_arr = np.zeros((self.batch, bucket), np.float32)
                for j, i in enumerate(chunk):
                    batch_arr[j] = pad_numpy(waves[i], bucket)
                x = torch.from_numpy(batch_arr)
                if self.mesh is None:  # a mesh's blocks go to their devices
                    x = x.to(self.device)
                emb, _ = fn(x)
                d = pairwise_distance(emb.float(), self.reference)
                d = d.cpu().numpy()
                for j, i in enumerate(chunk):
                    out_scores[i] = d[j]
        preds = (out_scores > self.threshold).astype(np.int32)
        return out_scores, preds


class BatchingQueue:
    """Dynamic batcher in front of a ScoringService.

    Single-utterance requests are grouped until the service batch size is
    reached or `max_wait_ms` elapses since the oldest queued request, then
    scored in one device call.

    submit() returns a Future resolving to (score, prediction);
    score_sync() is the blocking convenience wrapper.
    """

    def __init__(self, service: ScoringService, max_wait_ms: float = 5.0):
        self.service = service
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # serialises submit's check-then-put against close's stop flag:
        # without it a submit racing close() can enqueue its Future after
        # the worker's final drain, leaving the caller blocked forever
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, wave: np.ndarray) -> "Future":
        fut: Future = Future()
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("BatchingQueue is closed")
            self._q.put((np.asarray(wave, np.float32), fut))
        return fut

    def score_sync(self, wave: np.ndarray,
                   timeout: Optional[float] = None) -> Tuple[float, int]:
        return self.submit(wave).result(timeout=timeout)

    def close(self) -> None:
        with self._lock:
            self._stop.set()
        self._q.put(None)  # wake the worker
        self._thread.join()

    def __enter__(self) -> "BatchingQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ worker

    def _collect(self) -> List[Tuple[np.ndarray, Future]]:
        """Block for the first request, then fill the batch until the
        service batch size or the wait deadline."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.service.batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            waves = [w for w, _ in batch]
            try:
                scores, preds = self.service.score(waves)
            except Exception as e:  # propagate to all waiting callers
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            for i, (_, fut) in enumerate(batch):
                fut.set_result((float(scores[i]), int(preds[i])))
        # drain: fail anything still queued after close()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("queue closed"))
