"""Host input pipeline: shuffled meta-batch assembly with a background
prefetch thread (port of `occm_tpu.data.pipeline`, one process).

A background thread decodes and stacks the next G meta-batches
([G*12, cut]) while the card runs the step. A worker's error is re-raised
in the consumer: a failed decode fails the epoch, never truncates it.
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
    arrays, G = groups_per_step. One process: the epoch is not sharded. A
    ragged tail of fewer than G meta-batches is yielded at its own size
    unless drop_remainder."""

    def __init__(
        self,
        dataset: PFDataset,
        groups_per_step: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
        prefetch_depth: int = 2,
    ):
        self.dataset = dataset
        self.groups = groups_per_step
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.prefetch_depth = prefetch_depth

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.groups
        if not self.drop_remainder and len(self.dataset) % self.groups:
            n += 1
        return n

    def _epoch_iter(self, epoch: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        self.dataset.reseed(self.seed * 1_000_003 + epoch)
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

    def epoch(self, epoch: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return Prefetcher(self._epoch_iter(epoch), depth=self.prefetch_depth)
