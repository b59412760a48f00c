"""The port's PGD attack (`occm_tpu_torch.attack`) and linear SVM
baseline (`occm_tpu_torch.models.linearsvc`) against the JAX package's
(tests/test_attack_and_svc.py), on the CPU, torch pinned to one thread.

- PGD without the random start, on the same linear `logits_fn` (every
  entry of its input gradient at least 0.05 / B away from 0, so no sign
  can flip on a rounding): x_adv equal to JAX's at atol 1e-6 (a step
  moves each sample by alpha = 2/225 exactly; only the fp32 roundings of
  the sums differ). With the random start (a torch.Generator's draw):
  the ball, the clip and the target logit rising, as JAX's test holds
  its own.
- The SVM's hinge SGD replaying JAX's own epoch orders (`jax.random.split`
  and `permutation` as `_fit_hinge` calls them): w and b at rtol 1e-5 /
  atol 1e-6 of the JAX fit (the same fp32 updates in the same order),
  and the accuracy checks of the JAX suite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.attack import pgd_attack as jax_pgd_attack
from occm_tpu.models.linearsvc import _fit_hinge
from occm_tpu_torch.attack import pgd_attack
from occm_tpu_torch.models.linearsvc import SGD, fit_hinge


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _linear_logits(T, C=3, seed=0):
    """W [T, C] whose column differences all exceed 0.05 in size, for the
    two sides' logits_fn."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(T, C)).astype(np.float32)
    w[:, 1] = w[:, 0] + np.where(rng.random(T) < 0.5, -1, 1) * (
        0.05 + np.abs(rng.normal(size=T)))
    return w


@pytest.mark.parametrize("steps", [1, 10])
def test_pgd_without_random_start_matches_jax(steps):
    B, T = 4, 256
    w = _linear_logits(T)
    x = np.clip(np.random.default_rng(1).normal(size=(B, T)) * 0.3, -0.9,
                0.9).astype(np.float32)
    target = np.array([1, 0, 1, 2])
    want = np.asarray(jax_pgd_attack(
        lambda xx: xx @ jnp.asarray(w), jnp.asarray(x), jnp.asarray(target),
        jax.random.PRNGKey(0), steps=steps, random_start=False))
    tw = torch.from_numpy(w)
    got = pgd_attack(lambda xx: xx @ tw, torch.from_numpy(x),
                     torch.from_numpy(target), steps=steps,
                     random_start=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the attack moved every sample, inside the ball and [-1, 1]
    assert np.all(np.abs(got - x).max(axis=1) > 0)
    assert np.abs(got - x).max() <= 8 / 255 + 1e-6
    assert np.abs(got).max() <= 1.0


def test_pgd_moves_toward_target_within_ball():
    """tests/test_attack_and_svc.py:14-33 on the port, the random start
    from a generator."""
    def logits_fn(x):
        m = torch.mean(x, dim=1, keepdim=True)
        return torch.cat([-m, m], dim=1)

    x = torch.from_numpy((np.random.default_rng(0).normal(size=(3, 256))
                          * 0.1).astype(np.float32))
    target = torch.tensor([1, 1, 1])
    eps = 8 / 255
    x_adv = pgd_attack(logits_fn, x, target,
                       torch.Generator().manual_seed(0), eps=eps)
    assert float((x_adv - x).abs().max()) <= eps + 1e-6
    assert float(x_adv.abs().max()) <= 1.0
    assert torch.all(logits_fn(x_adv)[:, 1] > logits_fn(x)[:, 1])
    # another generator seed, another start
    other = pgd_attack(logits_fn, x, target,
                       torch.Generator().manual_seed(1), eps=eps, steps=0)
    first = pgd_attack(logits_fn, x, target,
                       torch.Generator().manual_seed(0), eps=eps, steps=0)
    assert not torch.equal(other, first)
    assert float((first - x).abs().max()) <= eps


def test_pgd_no_random_start_deterministic_and_needs_a_generator():
    """tests/test_attack_and_svc.py:36-45; a random start without a
    generator raises."""
    def logits_fn(x):
        m = torch.sum(x, dim=1, keepdim=True)
        return torch.cat([m, -m], dim=1)

    x = torch.zeros((1, 64))
    a1 = pgd_attack(logits_fn, x, torch.tensor([0]), random_start=False)
    a2 = pgd_attack(logits_fn, x, torch.tensor([0]),
                    torch.Generator().manual_seed(9), random_start=False)
    assert torch.equal(a1, a2)
    with pytest.raises(ValueError, match="Generator"):
        pgd_attack(logits_fn, x, torch.tensor([0]))


def _jax_orders(seed, n, epochs):
    """The permutations `_fit_hinge` draws, epoch by epoch."""
    key = jax.random.PRNGKey(seed)
    orders = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(sub, n)))
    return orders


def _standardised(seed, n=120, d=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(X @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0,
                 1.0, -1.0).astype(np.float32)
    Xs = ((X - X.mean(0)) / np.maximum(X.std(0), 1e-8)).astype(np.float32)
    return Xs, y


@pytest.mark.parametrize("alpha, lr0", [(1e-4, 1.0), (1e-2, 0.1)])
def test_hinge_sgd_matches_jax_on_jax_orders(alpha, lr0):
    Xs, y = _standardised(2)
    epochs = 4
    jw, jb = _fit_hinge(jnp.asarray(Xs), jnp.asarray(y),
                        jax.random.PRNGKey(7), alpha, lr0, epochs)
    w, b = fit_hinge(torch.from_numpy(Xs), torch.from_numpy(y), alpha, lr0,
                     epochs, orders=_jax_orders(7, len(y), epochs))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(b), float(jb), rtol=1e-5, atol=1e-6)


def test_sgd_class_matches_jax_predictions_on_jax_orders():
    from occm_tpu.models.linearsvc import SGD as JSGD

    rng = np.random.default_rng(3)
    X = rng.normal(size=(150, 6)).astype(np.float32)
    y = (X @ rng.normal(size=6) > 0).astype(int)
    want = JSGD(X, y, epochs=5, seed=4)
    got = SGD(X, y, epochs=5, device="cpu",
              orders=_jax_orders(4, len(y), 5))
    np.testing.assert_allclose(got._w, want._w, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))


def test_linear_svc_separable():
    """tests/test_attack_and_svc.py:48-57, the orders from a generator."""
    rng = np.random.default_rng(0)
    X0 = rng.normal(size=(200, 16)) - 2.0
    X1 = rng.normal(size=(200, 16)) + 2.0
    X = np.concatenate([X0, X1]).astype(np.float32)
    y = np.array([0] * 200 + [1] * 200)
    clf = SGD(X, y, epochs=20, device="cpu")
    assert clf.evaluate(X, y) > 0.97
    preds = clf.predict(np.array([[-2.0] * 16, [2.0] * 16], np.float32))
    np.testing.assert_array_equal(preds, [0, 1])


def test_linear_svc_matches_sklearn_accuracy_ballpark():
    """tests/test_attack_and_svc.py:60-75."""
    from sklearn.linear_model import SGDClassifier
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(1)
    n = 300
    X = rng.normal(size=(n, 8)).astype(np.float32)
    w_true = rng.normal(size=8)
    y = (X @ w_true + 0.5 * rng.normal(size=n) > 0).astype(int)
    ours = SGD(X, y, epochs=30, device="cpu").evaluate(X, y)
    sk = make_pipeline(
        StandardScaler(), SGDClassifier(max_iter=1000, tol=1e-3)
    ).fit(X, y).score(X, y)
    assert ours >= sk - 0.05


def test_sgd_runs_on_cuda_by_default():
    """The fit's device is CUDA unless the caller asks for the CPU: with
    no card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGD(np.zeros((4, 2), np.float32), np.array([0, 1, 0, 1]))
