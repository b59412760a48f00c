"""One-class reference-embedding scoring (port of
`occm_tpu.classify.scoring`; reference: oc_classifier.py).

- PHASE 1 (reference: oc_classifier.py:159-202): embed every bonafide train
  utterance; reference embedding = mean, threshold = max distance to the
  mean; artefacts cached with an exists-check (`reference_embedding.npy`,
  `threshold.npy`), distances appended to `distances.txt`.
- PHASE 2 (reference: oc_classifier.py:206-312): 1c writes
  "{distance}, {1 if > threshold else 0} \\n" per utterance, 2c the bare
  bonafide logit.

Utterances are repeat-padded up to a multiple of `bucket_step` samples and
embedded in full batches of `batch_size` rows (a short batch is padded with
zero rows, as in JAX), so every batch of a bucket has one shape and the
same kernel launches. Host batch assembly (pad and stack) runs on a
`Prefetcher` thread under the device compute of the previous batch.
Distances use torch `pairwise_distance` eps semantics.

Not ported yet: the multi-device `mesh=` (ROADMAP queue A item 15) and the
native threaded decode lane of `embed_paths` (item 12); here `embed_paths`
decodes with `io.wav.load_audio`, which gives the same waves.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from occm_tpu_torch.audio import pad_numpy
from occm_tpu_torch.classify.impl_select import select_attention_impl
from occm_tpu_torch.io.scorefiles import write_score_line_1c, write_score_line_2c
from occm_tpu_torch.losses import pairwise_distance
from occm_tpu_torch.serve import make_score_fn
from occm_tpu_torch.utils.device import resolve_device


def make_embed_fn_factory(model: torch.nn.Module, attention_impl: str = "auto",
                          norm_dtype: str = "float32"
                          ) -> Callable[[int], Callable]:
    """bucket_samples -> embed fn over one model: each bucket runs the
    attention impl that `select_attention_impl` picks for its length (a
    pinned impl passes through for every bucket)."""
    def factory(bucket_samples: int) -> Callable:
        return make_score_fn(model, select_attention_impl(
            bucket_samples, attention_impl, norm_dtype=norm_dtype))

    return factory


class BucketedEmbedder:
    """Batch variable-length utterances through per-bucket embed functions.

    embed_fn(x [B, T] tensor on `device`) -> (emb [B, D], logits [B, C]).
    Buckets are multiples of `bucket_step` samples; utterances are
    repeat-padded (reference pad semantics) up to the bucket boundary.
    """

    def __init__(self, embed_fn: Optional[Callable] = None,
                 bucket_step: int = 16000, max_len: Optional[int] = None,
                 batch_size: int = 8, mesh=None,
                 embed_fn_factory: Optional[Callable[[int], Callable]] = None,
                 device="cuda"):
        """max_len=None (default) never truncates: every utterance gets a
        bucket at least its own length, like the reference's full-length
        scoring (reference: oc_classifier.py:93-94).

        embed_fn_factory(bucket_samples) -> embed_fn: per-bucket embed
        functions (mutually exclusive with embed_fn), the plumbing behind
        attention_impl="auto".

        device: where batches go; "cuda" unless the caller asks for "cpu".
        mesh: multi-device scoring is not ported (raises)."""
        if mesh is not None:
            raise NotImplementedError(
                "multi-GPU scoring (mesh=) is not ported to occm_tpu_torch "
                "yet (ROADMAP queue A item 15)")
        if (embed_fn is None) == (embed_fn_factory is None):
            raise ValueError(
                "pass exactly one of embed_fn / embed_fn_factory")
        self.device = resolve_device(device)
        self._embed = embed_fn
        self._factory = embed_fn_factory
        self._per_bucket: dict = {}
        self.bucket_step = bucket_step
        self.max_len = max_len
        self.batch_size = batch_size

    def _embed_for(self, blen: int) -> Callable:
        if self._factory is None:
            return self._embed
        if blen not in self._per_bucket:
            self._per_bucket[blen] = self._factory(blen)
        return self._per_bucket[blen]

    def _bucket_len(self, n: int) -> int:
        b = ((n + self.bucket_step - 1) // self.bucket_step) * self.bucket_step
        b = max(b, self.bucket_step)
        return b if self.max_len is None else min(b, self.max_len)

    def _pad_batch_rows(self, batch: np.ndarray) -> np.ndarray:
        """Pad the batch dim to the full batch size: one shape per
        bucket."""
        pad_rows = self.batch_size - batch.shape[0]
        if pad_rows:
            batch = np.concatenate(
                [batch, np.zeros((pad_rows, batch.shape[1]), np.float32)])
        return batch

    def _run_batches(self, batch_iter, n: int,
                     progress: Optional[Callable[[int], None]],
                     prefetch_depth: int = 2
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Device loop over (chunk_indices, batch [B, blen]) items; the
        batches are assembled on a Prefetcher thread."""
        from occm_tpu_torch.data.pipeline import Prefetcher

        embs: List[Optional[np.ndarray]] = [None] * n
        logits_all: List[Optional[np.ndarray]] = [None] * n
        done = 0
        for chunk, batch in Prefetcher(batch_iter, depth=prefetch_depth):
            emb, logits = self._embed_for(batch.shape[1])(
                torch.from_numpy(batch).to(self.device))
            emb = emb.float().cpu().numpy()
            logits = logits.float().cpu().numpy()
            for j, i in enumerate(chunk):
                embs[i] = emb[j]
                logits_all[i] = logits[j]
            done += len(chunk)
            if progress:
                progress(done)
        return np.stack(embs), np.stack(logits_all)  # type: ignore[arg-type]

    def embed_all(self, waves: Iterable[np.ndarray],
                  progress: Optional[Callable[[int], None]] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Embed every waveform, preserving input order.
        Returns (embeddings [N, D], logits [N, C])."""
        waves = list(waves)
        by_bucket: dict = {}
        for i, w in enumerate(waves):
            by_bucket.setdefault(self._bucket_len(len(w)), []).append(i)

        def batches():
            for blen, idxs in sorted(by_bucket.items()):
                for start in range(0, len(idxs), self.batch_size):
                    chunk = idxs[start: start + self.batch_size]
                    batch = np.stack(
                        [pad_numpy(waves[i], blen) for i in chunk]
                    ).astype(np.float32)
                    yield chunk, self._pad_batch_rows(batch)

        return self._run_batches(batches(), len(waves), progress)

    def embed_paths(self, paths: List[str],
                    progress: Optional[Callable[[int], None]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Embed audio files by path, decoded with `io.wav.load_audio` (WAV
        or FLAC at the native rate): the same waves, buckets and results as
        `embed_all` on the decoded files."""
        from occm_tpu_torch.io.wav import load_audio

        return self.embed_all((load_audio(p, sr=None)[0] for p in paths),
                              progress)


class OneClassScorer:
    """Reference-embedding one-class scorer (reference: oc_classifier.py)."""

    def __init__(self, embedder: BucketedEmbedder, cache_dir: str = "."):
        self.embedder = embedder
        self.cache_dir = cache_dir

    def _embed_dataset(self, dataset, progress):
        """Embed a dataset by path when it exposes plain file paths
        (ASVDataset with the stock loader), otherwise item by item."""
        paths = None
        if hasattr(dataset, "file_paths"):
            paths = dataset.file_paths()
        if paths is not None:
            return self.embedder.embed_paths(paths, progress=progress)
        waves = (dataset[i][0] for i in range(len(dataset)))
        return self.embedder.embed_all(waves, progress=progress)

    @staticmethod
    def _distances(embs: np.ndarray, reference: np.ndarray) -> np.ndarray:
        return pairwise_distance(torch.from_numpy(embs),
                                 torch.from_numpy(reference)).numpy()

    # ---- phase 1 ----
    def create_reference_embedding(
        self, dataset, distances_txt: Optional[str] = "distances.txt",
        verbose: bool = False,
    ) -> Tuple[np.ndarray, float]:
        """Mean bonafide embedding + max-distance threshold with artefact
        cache resume (reference: oc_classifier.py:159-202)."""
        ref_path = os.path.join(self.cache_dir, "reference_embedding.npy")
        thr_path = os.path.join(self.cache_dir, "threshold.npy")
        if os.path.exists(ref_path) and os.path.exists(thr_path):
            return np.load(ref_path), float(np.load(thr_path))

        embs, _ = self._embed_dataset(
            dataset,
            progress=(lambda n: print(f"embedded {n} ...")) if verbose else None,
        )
        reference = embs.mean(axis=0)
        dists = self._distances(embs, reference)
        if distances_txt:
            with open(os.path.join(self.cache_dir, distances_txt), "a") as f:
                for d in dists:
                    f.write(f"{float(d)}\n")
        threshold = float(dists.max())

        np.save(ref_path, reference)
        np.save(thr_path, np.float32(threshold))
        return reference, threshold

    # ---- phase 2 ----
    def score_eval_set_1c(
        self, dataset, reference: np.ndarray, threshold: float,
        score_file: str = "scores.txt", verbose: bool = False,
    ) -> None:
        """One-class scoring: distance + thresholded prediction per line
        (reference: oc_classifier.py:243-265)."""
        embs, _ = self._embed_dataset(
            dataset,
            progress=(lambda n: print(f"Processing file counts: {n} ..."))
            if verbose else None,
        )
        dists = self._distances(embs, np.asarray(reference, np.float32))
        with open(score_file, "w") as f:
            for d in dists:
                write_score_line_1c(f, float(d), threshold)

    def score_eval_set_2c(
        self, dataset, score_file: str = "scores.txt",
        verbose: bool = False,
    ) -> None:
        """Two-class scoring: bare bonafide logit per line
        (reference: oc_classifier.py:293-312 writes out[0][0])."""
        _, logits = self._embed_dataset(
            dataset,
            progress=(lambda n: print(f"Processing file counts: {n} ..."))
            if verbose else None,
        )
        with open(score_file, "w") as f:
            for lg in logits:
                write_score_line_2c(f, float(lg[0]))  # bonafide logit
