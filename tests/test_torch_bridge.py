"""The port's weight bridge (`occm_tpu_torch.models.convert`) against the
JAX package's exporter (`occm_tpu.models.convert_backend`).

`state_dict_from_flax` is the port's own copy of the
`export_amodel_state_dict` mapping; it must agree with it key by key and
value by value, except for the one deliberate difference: the exporter
drops an all-zero conv feature-extractor bias (the mark of a bias-free
reference checkpoint) while the port's convs always carry one, so the
bridge always emits it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.convert_backend import export_amodel_state_dict
from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.models import AModel, state_dict_from_flax
from occm_tpu_torch.models.convert import load_reference_state_dict

CUT = 3200


@pytest.fixture(scope="module")
def flax_variables():
    """Tiny Flax AModel variables as numpy: every parameter perturbed,
    except the conv feature-extractor biases of layers 0 and 2, which
    keep Flax's all-zero init."""
    model = JAModel(JAASISTConfig.tiny(), xlsr_cfg=JXLSRConfig.tiny())
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda x: model.init(
        {"params": key, "dropout": key}, x))(jnp.zeros((2, CUT)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)

    def perturb(path, x):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "bias" and names[-2] in ("conv_0", "conv_2"):
            return x
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def test_bridge_matches_exporter_key_by_key(flax_variables):
    cfg = XLSRConfig.tiny()
    want = export_amodel_state_dict(flax_variables, JXLSRConfig.tiny())
    got = state_dict_from_flax(flax_variables, cfg)
    dropped = {f"ssl_model.model.feature_extractor.conv_layers.{i}.0.bias"
               for i in (0, 2)}
    assert set(got) - set(want) == dropped
    assert set(want) <= set(got)
    for k, v in want.items():
        g = got[k]
        assert isinstance(g, torch.Tensor), k
        assert tuple(g.shape) == np.shape(v), k
        np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=k)


def test_bridge_loads_strict(flax_variables):
    model = AModel(AASISTConfig.tiny(), XLSRConfig.tiny())
    sd = state_dict_from_flax(flax_variables, XLSRConfig.tiny())
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(model.state_dict())


def test_zero_conv_biases_are_emitted_as_zeros(flax_variables):
    """The trap at convert_backend.py:408: Flax inits conv biases to zero
    and the exporter drops all-zero biases, so a strict load of the
    exporter's dict fails; the bridge emits them."""
    sd = state_dict_from_flax(flax_variables, XLSRConfig.tiny())
    exported = export_amodel_state_dict(flax_variables, JXLSRConfig.tiny())
    for i in (0, 2):
        key = f"ssl_model.model.feature_extractor.conv_layers.{i}.0.bias"
        assert key not in exported
        assert torch.count_nonzero(sd[key]) == 0
        assert sd[key].shape == (XLSRConfig.tiny().conv_layers[i][0],)
    key = "ssl_model.model.feature_extractor.conv_layers.1.0.bias"
    np.testing.assert_array_equal(sd[key].numpy(), exported[key])
    model = AModel(AASISTConfig.tiny(), XLSRConfig.tiny())
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in exported.items()}, strict=True)


def test_pos_conv_weight_norm_folds_back(flax_variables):
    """g is the norm of v = w [C, C/G, K] over axes (0, 1); PosConv folds
    w = g * v / ||v|| back to the Flax kernel."""
    cfg = XLSRConfig.tiny()
    model = AModel(AASISTConfig.tiny(), cfg)
    model.load_state_dict(state_dict_from_flax(flax_variables, cfg))
    pos = model.ssl_model.model.encoder.pos_conv[0]
    c, k = cfg.encoder_embed_dim, cfg.conv_pos
    assert pos.weight_g.shape == (1, 1, k)
    assert pos.weight_v.shape == (c, c // cfg.conv_pos_groups, k)
    kernel = flax_variables["params"]["ssl_model"]["pos_conv"]["kernel"]
    want = np.asarray(kernel).transpose(2, 1, 0)
    with torch.no_grad():
        got = pos.weight().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a rescaled v folds to the same weight: only its direction counts
    with torch.no_grad():
        pos.weight_v.mul_(3.0)
        np.testing.assert_allclose(pos.weight().numpy(), want, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("wrap", ["plain", "model_key", "dataparallel"])
def test_load_reference_state_dict_file(flax_variables, tmp_path, wrap):
    sd = state_dict_from_flax(flax_variables, XLSRConfig.tiny())
    if wrap == "dataparallel":
        saved = {f"module.{k}": v for k, v in sd.items()}
    elif wrap == "model_key":
        saved = {"model": sd}
    else:
        saved = sd
    path = tmp_path / "amodel.pt"
    torch.save(saved, path)
    loaded = load_reference_state_dict(str(path))
    assert set(loaded) == set(sd)
    model = AModel(AASISTConfig.tiny(), XLSRConfig.tiny())
    model.load_state_dict(loaded, strict=True)
