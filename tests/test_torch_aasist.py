"""The port's AASIST backend and full `AModel` (`occm_tpu_torch.models`)
against the Flax modules, in eval mode.

Every parameter and BatchNorm statistic is perturbed on the Flax side
(running means off zero, variances off one), so eval-mode BatchNorm is not
the identity and a missing or misplaced BN shows. Tolerance: atol 3e-5 /
rtol 1e-4, that of tests/test_full_model_parity.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.aasist import GraphPool as JGraphPool
from occm_tpu.ops.pool import max_pool2d as jax_max_pool2d
from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.models import AModel, state_dict_from_flax
from occm_tpu_torch.models.aasist import GraphPool
from occm_tpu_torch.ops.pool import max_pool2d

CUT = 3200
ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture(scope="module")
def flax_amodel():
    model = JAModel(JAASISTConfig.tiny(), xlsr_cfg=JXLSRConfig.tiny())
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda x: model.init(
        {"params": key, "dropout": key}, x))(jnp.zeros((2, CUT)))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_amodel_matches_flax(flax_amodel, impl):
    jmodel, variables = flax_amodel
    x = (np.random.default_rng(1).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)
    want_emb, want_logits = jmodel.apply(variables, jnp.asarray(x),
                                         train=False)

    model = AModel(AASISTConfig.tiny(), XLSRConfig.tiny())
    model.load_state_dict(state_dict_from_flax(variables, XLSRConfig.tiny()),
                          strict=True)
    with torch.no_grad():
        emb, logits = model.eval()(torch.from_numpy(x), attention_impl=impl)
    assert emb.shape == (2, 5 * AASISTConfig.tiny().gat_dims[1])
    assert logits.shape == (2, 2)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=RTOL)


def test_eval_batchnorm_uses_running_stats(flax_amodel):
    """The port's eval forward does not depend on the other utterances of
    the batch (running statistics, not batch statistics)."""
    _, variables = flax_amodel
    model = AModel(AASISTConfig.tiny(), XLSRConfig.tiny()).eval()
    model.load_state_dict(state_dict_from_flax(variables, XLSRConfig.tiny()))
    x = (np.random.default_rng(2).normal(size=(3, CUT)) * 0.1).astype(
        np.float32)
    with torch.no_grad():
        both, _ = model(torch.from_numpy(x))
        alone, _ = model(torch.from_numpy(x[:1]))
    torch.testing.assert_close(alone[0], both[0], atol=ATOL, rtol=RTOL)


def test_graph_pool_matches_flax_order():
    """Top-k graph pooling keeps nodes in descending score order, as
    jax.lax.top_k does, and weights them by their sigmoid scores."""
    rng = np.random.default_rng(3)
    b, n, d, k = 3, 20, 8, 0.5
    h = rng.normal(size=(b, n, d)).astype(np.float32)
    pool = JGraphPool(k=k, p=0.0)
    params = pool.init(jax.random.PRNGKey(0), jnp.asarray(h))
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.3, np.shape(x)))
        .astype(np.float32), params)
    want = np.asarray(pool.apply(params, jnp.asarray(h)))

    port = GraphPool(k, d)
    with torch.no_grad():
        port.proj.weight.copy_(torch.from_numpy(
            params["params"]["proj"]["kernel"].T.copy()))
        port.proj.bias.copy_(torch.from_numpy(params["params"]["proj"]["bias"]))
        got = port(torch.from_numpy(h))
    assert got.shape == (b, n // 2, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)

    scores = rng.normal(size=(b, n)).astype(np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(scores), 7)
    _, tidx = torch.topk(torch.from_numpy(scores), 7, dim=1)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_graph_pool_breaks_ties_as_flax():
    """Large inputs saturate the sigmoid to exactly 1.0 for many nodes;
    the nodes kept among equal scores are those jax.lax.top_k keeps (the
    lower indices), whatever torch.topk would pick."""
    rng = np.random.default_rng(5)
    b, n, d = 2, 24, 8
    h = rng.normal(size=(b, n, d)).astype(np.float32)
    h[:, ::3] *= 200.0  # every third node saturates
    kernel = np.abs(rng.normal(size=(d, 1))).astype(np.float32)
    h[:, ::3] = np.abs(h[:, ::3])
    params = {"params": {"proj": {"kernel": kernel,
                                  "bias": np.zeros(1, np.float32)}}}
    want = np.asarray(JGraphPool(k=0.25, p=0.0).apply(params, jnp.asarray(h)))
    port = GraphPool(0.25, d)
    with torch.no_grad():
        port.proj.weight.copy_(torch.from_numpy(kernel.T.copy()))
        port.proj.bias.zero_()
        got = port(torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h, w", [(42, 30), (43, 31), (44, 29)])
def test_max_pool2d_matches_jax(h, w):
    """torch's floor-mode (3, 3) max pool on NCHW against the JAX op on
    NHWC, at sizes that are and are not multiples of the window."""
    x = np.random.default_rng(4).normal(size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_max_pool2d(jnp.asarray(x), (3, 3)))
    got = max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), (3, 3))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
