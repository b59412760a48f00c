"""Single-pass Adam (port of `occm_tpu.ops.fused_adam.FusedAdam`).

`FusedAdam(lr, b1, b2, eps)` keeps the first and second moments of every
parameter leaf and the step count. `step(params, grads)` updates every fp32
leaf in place. On CUDA tensors it launches the hand-written Hopper kernel
`csrc/fused_adam.cu` (replacing the TPU kernel `_kernel`) once for the
whole parameter list: the leaves are cut into chunks of `CHUNK` elements
and handed over as one table (`build_tables`), and the kernel reads p, m,
v, g once and writes p, m, v once. On CPU tensors the same table walk runs
`adam_reference`, the same formula (`_adam_math`) in plain PyTorch. The
step count t lives in a device tensor (`FusedAdam.count_t`): each step
increments it with a launch of its own, and then the kernel (or, on the
CPU, `bias_corrections_of`) computes the bias corrections 1/(1 - b^t) in
fp32 from it, as the JAX wrapper computes them outside its kernel. So no
per-step value is baked into a launch, and a CUDA graph of the step stays
right on every replay. Unlike the functional JAX optimizer, the update is
in place: parameters and moments are not copied.
The table's p, m and v pointers are kept across steps while every p, m and
v keeps its storage, which each step checks; only the gradient pointers are
gathered per step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: device launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

#: elements per chunk of a leaf (a multiple of 4: a leaf's chunks start on
#: 16-byte boundaries wherever the leaf does)
CHUNK = 1 << 16
#: leaves one launch's table holds (`kMaxLeaves` of csrc/fused_adam.cu)
MAX_LEAVES = 640


def bias_corrections(t: int, b1: float, b2: float):
    """(1/(1 - b1^t), 1/(1 - b2^t)) in fp32, as `_bias_corrections`."""
    tf = np.float32(t)
    one = np.float32(1.0)
    inv_bc1 = one / (one - np.power(np.float32(b1), tf))
    inv_bc2 = one / (one - np.power(np.float32(b2), tf))
    return float(inv_bc1), float(inv_bc2)


def bias_corrections_of(count: torch.Tensor, b1: float, b2: float):
    """(1/(1 - b1^t), 1/(1 - b2^t)) as fp32 tensors on the count's device,
    from the step count t in the 0-d tensor `count`: the plain version of
    the kernel's own computation (within one fp32 rounding of
    `bias_corrections`: the two fp32 pows may round apart)."""
    t = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=count.device)
    inv_bc1 = one / (one - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                                  device=count.device), t))
    inv_bc2 = one / (one - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                                  device=count.device), t))
    return inv_bc1, inv_bc2


def adam_reference(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, inv_bc1, inv_bc2, lr: float,
                   b1: float, b2: float, eps: float) -> None:
    """Plain version of the kernel's update: `_adam_math` with the given
    bias corrections (floats or 0-d fp32 tensors), written into p, m, v."""
    new_m = b1 * m + (1.0 - b1) * g
    new_v = b2 * v + (1.0 - b2) * g * g
    mhat = new_m * inv_bc1
    vhat = new_v * inv_bc2
    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
    m.copy_(new_m)
    v.copy_(new_v)


def build_tables(sizes: Sequence[int], present: Sequence[bool]
                 ) -> List[Tuple[List[int], List[int]]]:
    """The launches for leaves of `sizes` elements: one (leaves, starts)
    pair per launch, where the launch's k-th leaf `leaves[k]` owns chunks
    starts[k] .. starts[k + 1] - 1, of CHUNK elements each (its last one
    shorter). Leaves that are not `present` (no gradient) and empty leaves
    are left out; a launch holds at most MAX_LEAVES leaves."""
    leaves = [i for i, (n, ok) in enumerate(zip(sizes, present))
              if ok and n > 0]
    tables = []
    for lo in range(0, len(leaves), MAX_LEAVES):
        idx = leaves[lo:lo + MAX_LEAVES]
        starts = [0]
        for i in idx:
            starts.append(starts[-1] + -(-sizes[i] // CHUNK))
        tables.append((idx, starts))
    return tables


def _pointers(tensors) -> np.ndarray:
    return np.fromiter(map(torch.Tensor.data_ptr, tensors), np.int64,
                       len(tensors))


class _Plan:
    """The launches of one parameter list with one set of gradients
    present: the tables, and the p, m, v pointers, sizes and chunk prefix
    sums of each launch as the C entry point takes them. It holds every p,
    m and v, so no storage it points into is freed (and its address reused)
    while it lives."""

    def __init__(self, params, mu, nu, present):
        for p, m, v in zip(params, mu, nu):
            if not (p.shape == m.shape == v.shape):
                raise ValueError(f"p, m, v of different shapes: "
                                 f"{tuple(p.shape)}, {tuple(m.shape)}, "
                                 f"{tuple(v.shape)}")
            if not (p.device == m.device == v.device):
                raise ValueError("p, m, v on different devices")
            if not all(x.is_contiguous() for x in (p, m, v)):
                raise ValueError("fused Adam takes contiguous p, m, v")
        self.device = params[0].device if params else torch.device("cpu")
        if any(p.device != self.device for p in params):
            raise ValueError("parameters on different devices")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"fused Adam runs on cuda or cpu, not "
                             f"{self.device}")
        if self.device.type == "cuda" and any(
                x.dtype != torch.float32 for x in (*params, *mu, *nu)):
            raise ValueError("the CUDA kernel takes fp32 p, m, v, g")
        self.held = tuple(t.detach() for t in (*params, *mu, *nu))
        self.pointers = _pointers(self.held)
        self.present = tuple(present)
        self.tables = build_tables([p.numel() for p in params], present)
        self.arrays = [tuple(
            np.array([t[i].data_ptr() for i in idx], np.uint64)
            for t in (params, mu, nu)) + (
            np.array([params[i].numel() for i in idx], np.int64),
            np.array(starts, np.int32)) for idx, starts in self.tables]

    def matches(self, params, mu, nu, present) -> bool:
        """Whether the plan still points at params, mu and nu with these
        gradients present: a parameter whose storage was replaced (by
        `.to()`, `.float()` or `load_state_dict(assign=True)`, which keep the
        Parameter object) or reassigned moments need a new plan."""
        tensors = (*params, *mu, *nu)
        return (present == self.present and len(tensors) == len(self.held)
                and np.array_equal(_pointers(tensors), self.pointers))

    def run(self, params, mu, nu, grads, count: torch.Tensor,
            hyper) -> None:
        """Every launch of the plan: the kernel on the card, the same table
        walk in plain PyTorch on the CPU. `count` is the 0-d int64 step
        count t of this update on the parameters' device; `hyper` is (lr,
        b1, b2, eps)."""
        global LAUNCHES
        gs = [None if g is None else _grad_for(p, g)
              for p, g in zip(params, grads)]
        if count.device != self.device or count.dtype != torch.int64 or (
                count.dim() != 0):
            raise ValueError("the step count is a 0-d int64 tensor on the "
                             "parameters' device")
        lr, b1, b2, eps = hyper
        if self.device.type == "cpu":
            inv_bc1, inv_bc2 = bias_corrections_of(count, b1, b2)
            for idx, starts in self.tables:
                for k, i in enumerate(idx):
                    flat = [t.view(-1) for t in (params[i], mu[i], nu[i],
                                                 gs[i])]
                    n = flat[0].numel()
                    for c in range(starts[k + 1] - starts[k]):
                        s, e = c * CHUNK, min((c + 1) * CHUNK, n)
                        adam_reference(*(t[s:e] for t in flat), inv_bc1,
                                       inv_bc2, lr, b1, b2, eps)
            return
        if not all(g is None or g.is_cuda for g in gs):
            raise ValueError("gradients and parameters on different devices")

        from occm_tpu_torch.ops import _build

        lib = _build.load()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            for (idx, _), (pp, mp, vp, n, starts) in zip(self.tables,
                                                         self.arrays):
                gp = np.fromiter((gs[i].data_ptr() for i in idx), np.uint64,
                                 len(idx))
                err = lib.occm_fused_adam(
                    len(idx), pp.ctypes.data, mp.ctypes.data, vp.ctypes.data,
                    gp.ctypes.data, n.ctypes.data, starts.ctypes.data, CHUNK,
                    lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, count.data_ptr(),
                    stream)
                if err != 0:
                    raise RuntimeError(
                        f"occm_fused_adam failed: cudaError_t {err}")
                LAUNCHES += 1


def _grad_for(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g in p's shape, dtype and a contiguous layout."""
    if g.shape != p.shape:
        raise ValueError(f"gradient of shape {tuple(g.shape)} for a leaf of "
                         f"shape {tuple(p.shape)}")
    if g.dtype != p.dtype:
        g = g.to(p.dtype)
    return g if g.is_contiguous() else g.contiguous()


def fused_adam_leaf(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, count: torch.Tensor, lr: float,
                    b1: float, b2: float, eps: float) -> None:
    """One Adam step on one leaf, in place, at the step count t held in
    the 0-d int64 tensor `count` (on p's device): a one-leaf launch of the
    kernel on CUDA tensors (fp32, contiguous p, m, v of one shape), the
    plain version on CPU tensors."""
    if g.device != p.device:
        raise ValueError("p, m, v, g on different devices")
    _Plan([p], [m], [v], [True]).run([p], [m], [v], [g], count,
                                     (lr, b1, b2, eps))


class FusedAdam:
    """Single-pass Adam over a list of fp32 parameter tensors."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = float(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        #: the step count, a 0-d int64 tensor on the parameters' device
        self.count_t = torch.zeros((), dtype=torch.int64)
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        self._plan: Optional[_Plan] = None

    @property
    def count(self) -> int:
        """The step count (a host read of `count_t`)."""
        return int(self.count_t)

    @count.setter
    def count(self, value: int) -> None:
        self.count_t.fill_(int(value))

    def init(self, params: Sequence[torch.Tensor]) -> "FusedAdam":
        """Zero moments shaped like `params`, step count 0 (on their
        device)."""
        device = params[0].device if params else torch.device("cpu")
        self.count_t = torch.zeros((), dtype=torch.int64, device=device)
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]
        self._plan = None
        return self

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update of every leaf in place; the step count goes up by
        one, on the device, before the update reads it. A leaf whose
        gradient is None (a parameter the forward never used) is left as it
        is, as torch.optim.Adam leaves it."""
        if not (len(params) == len(grads) == len(self.mu)):
            raise ValueError(
                f"{len(params)} params, {len(grads)} grads, {len(self.mu)} "
                "moments: call init(params) first")
        present = tuple(g is not None for g in grads)
        if self._plan is None or not self._plan.matches(
                params, self.mu, self.nu, present):
            self._plan = _Plan(params, self.mu, self.nu, present)
        self.count_t.add_(1)
        self._plan.run(params, self.mu, self.nu, grads, self.count_t,
                       (self.lr, self.b1, self.b2, self.eps))
