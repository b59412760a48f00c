"""k training steps as one CUDA graph: the port's counterpart of the JAX
package's `make_multi_step` (a `lax.scan` of k steps in one jitted
dispatch, `occm_tpu/train/loop.py:83-111`).

`GraphedSteps.run(xs, labels)` takes a chunk of k full batches (numpy,
[k, B, T] and [k, B]) and runs k `train_step`s on it with one graph launch.
The first chunk of each shape is captured: one eager step on the capture
stream first (cuBLAS workspaces, kernel attributes, the LayerNorm
kernel's scratch for that stream and the optimizer's state are made
there), after which the model, optimizer and generator are set back to
their state before it; then the k steps are captured into one
`torch.cuda.CUDAGraph` and replayed once per chunk. A capture that fails
raises; nothing falls back to eager steps.

What the graph holds fixed, and why it stays right:
- the inputs: static [k, B, T] / [k, B] buffers, which each chunk is copied
  into from pinned host memory before the replay;
- the gradients: tensors of the graph's pool. Each captured step starts
  with none, so its backward writes them; after the capture the
  parameters' .grad are None again for eager steps;
- RawBoost's draws and the dropout masks: drawn from the state's CUDA
  generator, registered with the graph, whose Philox offset advances by
  the graph's draws on every replay (eager steps from the same state draw
  the same augmentation and masks); the augmentation reads no device
  value on the host, so it is captured with the step;
- the step count: `state.step_t` on the device, incremented by every
  captured step, is what the A-softmax loss anneals lambda from, so
  lambda moves from step to step and from replay to replay;
- the optimizer: FusedAdam's step count and bias corrections are read from
  the device by its kernel; torch.optim.Adam on a card is always
  capturable (step on the device, as in eager steps) and reads its lr
  from a device tensor, which each captured step copies from a [k]
  buffer that the host fills from the schedule before the replay;
- the collectives of a step on a mesh (NCCL; warmed up by the eager step,
  on the capture stream, before the capture): the gradient all-reduce,
  the BatchNorm sums and the loss's all-gather run inside the graph, and
  the fsdp all-gathers and reduce-scatters too, into tensors of the
  graph's pool (the `.data` swaps between a shard and its gathered whole
  are host-side and land on the same shard storage after every replay);
- every pointer the kernels' launches and TMA descriptors baked in:
  parameters, moments and buffers keep their storage (nothing here calls
  `.to()` or replaces a `.data` after the capture).
The kernel wrappers count launches in Python, so they tick during the
capture only: `capture_launches` keeps what one capture added (one
replay's launches), `replays` the graph launches.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Tuple

import numpy as np
import torch

from occm_tpu_torch.ops import launch_counts
from occm_tpu_torch.ops.fused_adam import FusedAdam


def _key(xs: np.ndarray, replicated: bool) -> Tuple:
    """A capture's key: the chunk's shape (and "replicated" for a chunk
    every rank holds whole)."""
    return tuple(xs.shape) + (("replicated",) if replicated else ())


class _Captured:
    """One captured chunk shape: the graph, its static buffers."""

    def __init__(self, graph, xs, labels, lrs, out):
        self.graph = graph
        self.xs = xs          # [k, B, T] fp32
        self.labels = labels  # [k, B] int64
        self.lrs = lrs        # [k] fp32, the schedule's lr of each step
        self.out = out        # [k, 4] fp32: loss, closs, dloss, lr


class GraphedSteps:
    """k train steps of `state` per graph launch, on the state's CUDA
    device (see the module docstring)."""

    def __init__(self, state, cfg, k: int):
        self.state = state
        self.cfg = cfg
        self.k = k
        self.device = next(state.model.parameters()).device
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA model, not "
                             f"{self.device}")
        self._graphs: Dict[Tuple[int, ...], _Captured] = {}
        #: chunk shape -> the wrappers' launches that its capture added
        self.capture_launches: Dict[Tuple[int, ...], Dict[str, int]] = {}
        #: chunk shape -> seconds of warm-up and capture
        self.capture_seconds: Dict[Tuple[int, ...], float] = {}
        #: graph launches
        self.replays = 0

    def run(self, xs: np.ndarray, labels: np.ndarray,
            replicated: bool = False) -> Dict:
        """k steps on a chunk: metrics as device tensors, "loss", "closs",
        "dloss" the chunk's means and "step_loss", "step_closs",
        "step_dloss", "step_lr" each step's [k]. On a mesh the chunk is
        this rank's rows (`replicated`: every rank's whole batch; see
        `train_step`)."""
        shape = _key(xs, replicated)
        cap = self._graphs.get(shape)
        if cap is None:
            cap = self._capture(xs, labels, replicated)
        self._load(cap, xs, labels)
        cap.graph.replay()
        self.replays += 1
        self.state.step += self.k
        out = cap.out.clone()
        return {"loss": out[:, 0].mean(), "closs": out[:, 1].mean(),
                "dloss": out[:, 2].mean(), "step_loss": out[:, 0],
                "step_closs": out[:, 1], "step_dloss": out[:, 2],
                "step_lr": out[:, 3]}

    def _load(self, cap: _Captured, xs: np.ndarray,
              labels: np.ndarray) -> None:
        """The chunk and its lrs into the static buffers, from pinned host
        memory, on the current stream (the replay's)."""
        cap.xs.copy_(torch.from_numpy(np.ascontiguousarray(
            xs, np.float32)).pin_memory(), non_blocking=True)
        cap.labels.copy_(torch.from_numpy(np.ascontiguousarray(
            labels, np.int64)).pin_memory(), non_blocking=True)
        if self.state.schedule is not None:
            lrs = [self.state.schedule(self.state.step + i)
                   for i in range(self.k)]
            cap.lrs.copy_(torch.tensor(lrs, dtype=torch.float32)
                          .pin_memory(), non_blocking=True)

    def _capture(self, xs: np.ndarray, labels: np.ndarray,
                 replicated: bool) -> _Captured:
        from occm_tpu_torch.train.loop import train_step

        state, cfg, dev = self.state, self.cfg, self.device
        t0 = time.perf_counter()
        k = self.k
        cap = _Captured(
            torch.cuda.CUDAGraph(),
            torch.empty(xs.shape, dtype=torch.float32, device=dev),
            torch.empty(labels.shape, dtype=torch.int64, device=dev),
            torch.empty((k,), dtype=torch.float32, device=dev),
            torch.empty((k, 4), dtype=torch.float32, device=dev))
        self._load(cap, xs, labels)
        stream = torch.cuda.Stream(dev)
        saved = self._snapshot()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            train_step(state, cap.xs[0], cap.labels[0], cfg,
                       replicated=replicated)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self._restore(saved)
        del saved
        params = [p for p in state.model.parameters()]
        for p in params:
            p.grad = None
        opt = state.optimizer
        if isinstance(opt, FusedAdam):
            lr_t = torch.full((), opt.lr, dtype=torch.float32, device=dev)
        else:
            lr_t = opt.param_groups[0]["lr"]
        step0 = state.step
        cap.graph.register_generator_state(state.generator)
        before = launch_counts()
        with torch.cuda.graph(cap.graph, stream=stream):
            for i in range(k):
                lr = cap.lrs[i] if state.schedule is not None else None
                m = train_step(state, cap.xs[i], cap.labels[i], cfg, lr=lr,
                               replicated=replicated)
                for j, key in enumerate(("loss", "closs", "dloss")):
                    cap.out[i, j].copy_(m[key])
                cap.out[i, 3].copy_(lr_t)
        after = launch_counts()
        state.step = step0
        for p in params:
            p.grad = None
        shape = _key(xs, replicated)
        self._graphs[shape] = cap
        self.capture_launches[shape] = {n: after[n] - before[n]
                                        for n in after}
        torch.cuda.synchronize(dev)
        self.capture_seconds[shape] = time.perf_counter() - t0
        return cap

    # the warm-up step is undone: everything it changed is set back in
    # place, so the tensors the graph captures are the state's own

    def _tensors(self):
        state = self.state
        opt = state.optimizer
        tensors = list(itertools.chain(state.model.parameters(),
                                       state.model.buffers()))
        tensors.append(state.step_t)
        if isinstance(opt, FusedAdam):
            tensors += [*opt.mu, *opt.nu, opt.count_t]
        return tensors

    @torch.no_grad()
    def _snapshot(self):
        opt = self.state.optimizer
        adam = {} if isinstance(opt, FusedAdam) else {
            p: {n: t.clone() for n, t in s.items()}
            for p, s in opt.state.items()}
        return ([t.detach().clone() for t in self._tensors()], adam,
                self.state.generator.get_state(), self.state.step)

    @torch.no_grad()
    def _restore(self, saved) -> None:
        tensors, adam, rng, step = saved
        for t, s in zip(self._tensors(), tensors):
            t.copy_(s)
        opt = self.state.optimizer
        if not isinstance(opt, FusedAdam):
            for p, s in opt.state.items():
                for n, t in s.items():
                    if p in adam:
                        t.copy_(adam[p][n])
                    else:  # made by the warm-up: a fresh state is zeros
                        t.zero_()
        self.state.generator.set_state(rng)
        self.state.step = step
