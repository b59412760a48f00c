"""Profiling hooks (port of `occm_tpu.utils.profiling`).

`profile_trace(logdir)` records the block under `torch.profiler` (CPU
activity, and CUDA activity where a card is present) and writes its trace
under `logdir` in TensorBoard's profiler layout
(`<worker>.<time>.pt.trace.json`, a Chrome trace). `StepTimer` gives cheap
wall-clock step timing with warmup-aware summaries; like the JAX
package's, it reads the host clock only, so a step it times on a card
must end in a host read (or a synchronize) to be counted whole.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the block into `logdir` (created); yields the profiler, whose
    `key_averages()` the caller may read after the block."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def steady(self) -> List[float]:
        return self.times[self.warmup:] if len(self.times) > self.warmup \
            else self.times

    def mean(self) -> float:
        s = self.steady
        return sum(s) / max(len(s), 1)
