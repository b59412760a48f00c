"""Host input pipeline: shuffled meta-batch assembly with a background
prefetch thread (port of `occm_tpu.data.pipeline`), its epoch sharded over
the data axes of a rank mesh.

A background thread decodes and stacks the next G meta-batches
([G*12, cut]) while the card runs the step: with repeat padding and the
stock loader, as one threaded native decode of the step's 12*G files
(`io.native`), else item by item in Python; both give the same batches
bit for bit. A worker's error is re-raised in the consumer: a failed
decode fails the epoch, never truncates it.
`chunk_batches` groups an epoch's batches into chunks of k for
`steps_per_dispatch` (port of `occm_tpu.train.loop.chunk_batches`).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from occm_tpu_torch.data.datasets import PFDataset


class Prefetcher:
    """Wrap any iterator with a depth-N background prefetch thread."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class MetaBatchPipeline:
    """Epoch iterator over PFDataset yielding ([G*12, cut], [G*12]) numpy
    arrays, G = groups_per_step. A ragged tail of fewer than G meta-batches
    is yielded at its own size unless drop_remainder. `decode_threads`:
    threads of the native batch decode, taken where
    `dataset.supports_native_batch()`.

    Sharding (JAX's multi-host slicing): every rank shuffles with the same
    seed, truncates the epoch order to a multiple of shard_count (so every
    rank runs the same number of steps, and the collectives meet) and takes
    the strided slice order[shard_index::shard_count]; the global batch is
    the concatenation of the ranks' batches. The defaults come from
    `parallel.data_shard_for_process(mesh)` with a mesh (ranks of one tp
    group load identical data), else one shard per rank of the process
    group (one shard without one)."""

    def __init__(
        self,
        dataset: PFDataset,
        groups_per_step: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
        prefetch_depth: int = 2,
        decode_threads: int = 8,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
        mesh=None,
    ):
        self.dataset = dataset
        self.groups = groups_per_step
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.prefetch_depth = prefetch_depth
        self.decode_threads = decode_threads
        if shard_index is None or shard_count is None:
            from occm_tpu_torch.parallel import multihost
            from occm_tpu_torch.parallel.mesh import data_shard_for_process

            if mesh is not None:
                shard_index, shard_count = data_shard_for_process(mesh)
            else:
                shard_index = multihost.process_index()
                shard_count = multihost.process_count()
        if not 0 <= shard_index < shard_count:
            raise ValueError(
                f"shard_index {shard_index} not in [0, {shard_count})")
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._native = (hasattr(dataset, "supports_native_batch")
                        and dataset.supports_native_batch())

    def _shard_len(self) -> int:
        return len(self.dataset) // self.shard_count

    def steps_per_epoch(self) -> int:
        n = self._shard_len() // self.groups
        if not self.drop_remainder and self._shard_len() % self.groups:
            n += 1
        return n

    def _epoch_iter(self, epoch: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        if self.shard_count > 1:
            usable = (len(order) // self.shard_count) * self.shard_count
            order = order[:usable][self.shard_index::self.shard_count]
        self.dataset.reseed(self.seed * 1_000_003 + epoch)
        if self._native:
            yield from self._native_epoch_iter(order)
            return
        group_feats, group_labels = [], []
        for idx in order:
            f, l = self.dataset[int(idx)]
            group_feats.append(f)
            group_labels.append(l)
            if len(group_feats) == self.groups:
                yield (np.concatenate(group_feats, axis=0),
                       np.concatenate(group_labels, axis=0))
                group_feats, group_labels = [], []
        if group_feats and not self.drop_remainder:
            yield (np.concatenate(group_feats, axis=0),
                   np.concatenate(group_labels, axis=0))

    def _native_epoch_iter(self, order: np.ndarray):
        """The 12*G paths of each step resolved by `sample_paths` (the same
        per-index draws as `__getitem__`) and decoded by one threaded
        native call, repeat-padded to `cut` in its output buffer; the
        ragged tail likewise unless drop_remainder."""
        from occm_tpu_torch.io.native import native_read_batch_padded

        steps = [order[i: i + self.groups]
                 for i in range(0, len(order), self.groups)]
        if steps and len(steps[-1]) < self.groups and self.drop_remainder:
            steps.pop()
        for idxs in steps:
            paths, labels = [], []
            for idx in idxs:
                p, l = self.dataset.sample_paths(int(idx))
                paths += p
                labels.append(l)
            feats, _, _ = native_read_batch_padded(
                paths, self.dataset.cut, n_threads=self.decode_threads)
            yield feats, np.concatenate(labels)

    def epoch(self, epoch: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return Prefetcher(self._epoch_iter(epoch), depth=self.prefetch_depth)


def chunk_batches(batch_iter, full_batch: int, k_dispatch: int):
    """Group an epoch's (x, labels) stream into ("chunk", xs [k, B, T],
    labels [k, B]) stacks of k_dispatch full batches (B = full_batch), and
    pass every batch that cannot fill a chunk through as ("single", x,
    labels), so no batch is dropped and the updates stay in data order: a
    ragged batch flushes the buffered full batches before itself, and the
    epoch's leftover full batches come out one by one at its end. Labels
    come out int64."""
    if k_dispatch == 1:
        for x, labels in batch_iter:
            yield "single", x, np.asarray(labels, np.int64)
        return
    xs, ls = [], []
    for x, labels in batch_iter:
        labels = np.asarray(labels, np.int64)
        if x.shape[0] != full_batch:
            for xb, lb in zip(xs, ls):
                yield "single", xb, lb
            xs, ls = [], []
            yield "single", np.asarray(x), labels
            continue
        xs.append(np.asarray(x))
        ls.append(labels)
        if len(xs) == k_dispatch:
            yield "chunk", np.stack(xs), np.stack(ls)
            xs, ls = [], []
    for x, labels in zip(xs, ls):
        yield "single", x, labels
