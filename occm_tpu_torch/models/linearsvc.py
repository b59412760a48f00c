"""Linear SVM baseline over precomputed embeddings (port of
`occm_tpu.models.linearsvc`).

Parity target: reference models/linearsvc.py:6-19, an sklearn pipeline of
StandardScaler + SGDClassifier (hinge loss, L2 alpha=1e-4). The same
estimator as the JAX package's: hinge SGD on standardised features, one
sample at a time in a random order per epoch, with sklearn's "optimal"-
style step decay lr0 / (1 + lr0 alpha t).

The fit runs on a device (CUDA unless the caller asks for the CPU). Each
epoch's order comes from a `torch.Generator` on that device, or is given
explicitly (`orders`, so two devices, or the JAX package's
`jax.random.permutation` orders, can be replayed). The update is
sequential per sample, so on a card the fit is launch-bound: n x epochs
updates of a few small launches each, with no host read until the end.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from occm_tpu_torch.utils.device import resolve_device


def fit_hinge(X: torch.Tensor, y: torch.Tensor, alpha: float, lr0: float,
              epochs: int, generator: Optional[torch.Generator] = None,
              orders: Optional[Sequence] = None):
    """Hinge SGD: X [n, d] standardised, y [n] in {-1, +1}, both on one
    device -> (w [d], b []) there. Epoch e visits the rows in `orders[e]`
    (a permutation of range(n)) if given, else in torch.randperm(n) from
    `generator`. The JAX package's `_fit_hinge`, step for step: sample i of
    epoch e is step t = e n + i + 1 at lr = lr0 / (1 + lr0 alpha t), and a
    margin below 1 adds y x to the descent direction."""
    n, d = X.shape
    w = X.new_zeros(d)
    b = X.new_zeros(())
    zero = X.new_zeros(())
    for e in range(epochs):
        if orders is not None:
            order = torch.as_tensor(np.array(orders[e]), device=X.device)
        else:
            order = torch.randperm(n, generator=generator, device=X.device)
        Xe, ye = X[order], y[order]
        for i in range(n):
            t = e * n + i + 1
            lr = lr0 / (1.0 + lr0 * alpha * t)
            xi, yi = Xe[i], ye[i]
            coef = torch.where(yi * (xi @ w + b) < 1.0, yi, zero)
            w = w - lr * (alpha * w - coef * xi)
            b = b - lr * (-coef)
    return w, b


class SGD:
    """Drop-in for the reference SGD class (train / predict / evaluate):
    the fit on `device`, the predictions on the host, as the JAX
    package's."""

    def __init__(self, X, y, alpha: float = 1e-4, lr0: float = 1.0,
                 epochs: int = 50, seed: int = 0, device="cuda",
                 orders: Optional[Sequence] = None):
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        assert len(self.classes_) == 2, "binary baseline"
        self._mu = X.mean(axis=0)
        self._sd = np.maximum(X.std(axis=0), 1e-8)
        Xs = (X - self._mu) / self._sd
        ypm = np.where(y == self.classes_[1], 1.0, -1.0).astype(np.float32)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        w, b = fit_hinge(torch.from_numpy(Xs).to(dev),
                         torch.from_numpy(ypm).to(dev), alpha, lr0, epochs,
                         generator=gen, orders=orders)
        self._w = w.cpu().numpy()
        self._b = float(b)

    def decision_function(self, X):
        Xs = (np.asarray(X, np.float32) - self._mu) / self._sd
        return Xs @ self._w + self._b

    def predict(self, X):
        return np.where(
            self.decision_function(X) >= 0, self.classes_[1], self.classes_[0]
        )

    def evaluate(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))
