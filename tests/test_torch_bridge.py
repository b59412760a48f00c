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
    and the exporter drops all-zero biases; the bridge emits them, and the
    port's extractor loads the exporter's dict strictly all the same (a
    missing conv bias loads as zeros, as in a bias-free wav2vec2-base
    checkpoint), to the bridge's parameters."""
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
    model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in exported.items()}, strict=True)
    for k, v in model.state_dict().items():
        if k.startswith("ssl_model.model.feature_extractor."):
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_pos_conv_weight_norm_folds_back(flax_variables):
    """g is the norm of v = w [C, C/G, K] over axes (0, 1); PosConv folds
    w = g * v / ||v|| into the kernel it trains, the Flax kernel; a
    rescaled v folds to the same kernel (only its direction counts); and
    its state dict is fairseq's pair again, v = w and g = ||w||, which
    loads back to the same kernel bit for bit."""
    cfg = XLSRConfig.tiny()
    model = AModel(AASISTConfig.tiny(), cfg)
    sd = state_dict_from_flax(flax_variables, cfg)
    model.load_state_dict(sd, strict=True)
    pos = model.ssl_model.model.encoder.pos_conv[0]
    c, k = cfg.encoder_embed_dim, cfg.conv_pos
    assert [n for n, _ in pos.named_parameters()] == ["weight", "bias"]
    assert pos.weight.shape == (c, c // cfg.conv_pos_groups, k)
    kernel = flax_variables["params"]["ssl_model"]["pos_conv"]["kernel"]
    want = np.asarray(kernel).transpose(2, 1, 0)
    np.testing.assert_allclose(pos.weight.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    key = "ssl_model.model.encoder.pos_conv.0."
    sd[key + "weight_v"] = 3.0 * sd[key + "weight_v"]
    model.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(pos.weight.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    saved = model.state_dict()
    assert saved[key + "weight_g"].shape == (1, 1, k)
    assert torch.equal(saved[key + "weight_v"], pos.weight.detach())
    again = AModel(AASISTConfig.tiny(), cfg)
    again.load_state_dict(saved, strict=True)
    assert torch.equal(again.ssl_model.model.encoder.pos_conv[0].weight,
                       pos.weight)


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
