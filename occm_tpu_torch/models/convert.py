"""The weight bridge: Flax `AModel` variables -> a state dict in the
reference's torch naming, which the port's modules load with
`load_state_dict(strict=True)`.

This is the port's own copy of the mapping of
`occm_tpu.models.convert_backend.export_xlsr_state_dict` and
`export_amodel_state_dict`, with one difference: the export drops a conv
feature-extractor bias that is all zeros (a bias-free reference
checkpoint), while the port's convs always have a bias, so the bridge
always emits it. Inputs are plain numpy arrays, so the port needs no JAX
to read a tree that was saved to disk.

Layouts: Flax Dense kernel [in, out] -> Linear weight [out, in]; Flax
Conv kernel [K, in, out] -> Conv1d [out, in, K]; Flax Conv HWIO ->
Conv2d OIHW. The positional conv is split into fairseq's weight norm with
g = the norm over axes (0, 1) of v = w [C, C/G, K], which PosConv folds
back exactly.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from occm_tpu_torch.config import XLSRConfig


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _a(p["kernel"]).T
    if "bias" in p:
        out[f"{key}.bias"] = _a(p["bias"])


def _conv2d(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _a(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{key}.bias"] = _a(p["bias"])


def _bn(out: Dict, key: str, p: Mapping, s: Optional[Mapping]) -> None:
    out[f"{key}.weight"] = _a(p["scale"])
    out[f"{key}.bias"] = _a(p["bias"])
    if s is None:  # parameters only
        return
    out[f"{key}.running_mean"] = _a(s["mean"])
    out[f"{key}.running_var"] = _a(s["var"])
    out[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)


def _bn_default(out: Dict, key: str, n: int) -> None:
    """A reference BatchNorm whose output the forward discards."""
    out[f"{key}.weight"] = np.ones(n, np.float32)
    out[f"{key}.bias"] = np.zeros(n, np.float32)
    out[f"{key}.running_mean"] = np.zeros(n, np.float32)
    out[f"{key}.running_var"] = np.ones(n, np.float32)
    out[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)


def xlsr_arrays_from_flax(params: Mapping, cfg: XLSRConfig) -> Dict:
    """XLSREncoder params -> {fairseq wav2vec2 name: numpy array}."""
    out: Dict = {}
    fe = params["feature_extractor"]
    for i, (dim, _, _) in enumerate(cfg.conv_layers):
        conv = fe[f"conv_{i}"]
        out[f"feature_extractor.conv_layers.{i}.0.weight"] = _a(
            conv["kernel"]).transpose(2, 1, 0)
        out[f"feature_extractor.conv_layers.{i}.0.bias"] = (
            _a(conv["bias"]) if "bias" in conv else np.zeros(dim, np.float32))
        out[f"feature_extractor.conv_layers.{i}.2.1.weight"] = _a(
            fe[f"ln_{i}"]["scale"])
        out[f"feature_extractor.conv_layers.{i}.2.1.bias"] = _a(
            fe[f"ln_{i}"]["bias"])

    out["layer_norm.weight"] = _a(params["layer_norm"]["scale"])
    out["layer_norm.bias"] = _a(params["layer_norm"]["bias"])
    if "post_extract_proj" in params:
        _linear(out, "post_extract_proj", params["post_extract_proj"])

    w = _a(params["pos_conv"]["kernel"]).transpose(2, 1, 0)  # [C, C/G, K]
    out["encoder.pos_conv.0.weight_g"] = np.sqrt(
        np.sum(w ** 2, axis=(0, 1), keepdims=True))
    out["encoder.pos_conv.0.weight_v"] = w
    out["encoder.pos_conv.0.bias"] = _a(params["pos_conv"]["bias"])

    layer = params["layers"]["layer"]
    for l in range(cfg.encoder_layers):
        base = f"encoder.layers.{l}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            p = layer["self_attn"][name]
            _linear(out, f"{base}.self_attn.{name}",
                    {"kernel": _a(p["kernel"])[l], "bias": _a(p["bias"])[l]})
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            out[f"{base}.{name}.weight"] = _a(layer[name]["scale"])[l]
            out[f"{base}.{name}.bias"] = _a(layer[name]["bias"])[l]
        for name in ("fc1", "fc2"):
            _linear(out, f"{base}.{name}",
                    {"kernel": _a(layer[name]["kernel"])[l],
                     "bias": _a(layer[name]["bias"])[l]})

    out["encoder.layer_norm.weight"] = _a(params["encoder_layer_norm"]["scale"])
    out["encoder.layer_norm.bias"] = _a(params["encoder_layer_norm"]["bias"])
    return out


class _NoStats(dict):
    """batch_stats stand-in of a parameter-only mapping: every BatchNorm's
    statistics are None."""

    def __getitem__(self, key):
        return self

    def get(self, key, default=None):
        return None


def amodel_arrays_from_flax(variables: Mapping,
                            xlsr_cfg: Optional[XLSRConfig] = None,
                            params_only: bool = False) -> Dict:
    """AModel variables -> {reference torch name: numpy array}. With
    params_only, only the trainable parameters that the Flax tree has (no
    BatchNorm statistics, no never-run bn1): the mapping of any tree shaped
    like the parameters, such as Adam's moments."""
    xlsr_cfg = xlsr_cfg or XLSRConfig()
    p = variables["params"]["backend"]
    s = _NoStats() if params_only else \
        variables.get("batch_stats", {}).get("backend", {})
    out: Dict = {
        f"ssl_model.model.{k}": v
        for k, v in xlsr_arrays_from_flax(
            variables["params"]["ssl_model"], xlsr_cfg).items()
    }

    _linear(out, "LL", p["LL"])
    _bn(out, "first_bn", p["first_bn"], s.get("first_bn"))
    _bn(out, "first_bn1", p["first_bn1"], s.get("first_bn1"))
    for i in range(6):
        base = f"encoder.{i}.0"
        blk, bst = p[f"encoder_{i}"], s[f"encoder_{i}"]
        if i > 0 and not params_only:
            _bn_default(out, f"{base}.bn1", _a(blk["conv1"]["kernel"]).shape[2])
        _conv2d(out, f"{base}.conv1", blk["conv1"])
        _bn(out, f"{base}.bn2", blk["bn2"], bst.get("bn2"))
        _conv2d(out, f"{base}.conv2", blk["conv2"])
        if "conv_downsample" in blk:
            _conv2d(out, f"{base}.conv_downsample", blk["conv_downsample"])

    _conv2d(out, "attention.0", p["att_conv1"])
    _bn(out, "attention.2", p["att_bn"], s.get("att_bn"))
    _conv2d(out, "attention.3", p["att_conv2"])
    for name in ("pos_S", "master1", "master2"):
        out[name] = _a(p[name])

    for name in ("GAT_layer_S", "GAT_layer_T"):
        for sub in ("att_proj", "proj_with_att", "proj_without_att"):
            _linear(out, f"{name}.{sub}", p[name][sub])
        out[f"{name}.att_weight"] = _a(p[name]["att_weight"])
        _bn(out, f"{name}.bn", p[name]["bn"], s[name].get("bn"))
    for name in ("HtrgGAT_layer_ST11", "HtrgGAT_layer_ST12",
                 "HtrgGAT_layer_ST21", "HtrgGAT_layer_ST22"):
        for sub in ("proj_type1", "proj_type2", "att_proj", "att_projM",
                    "proj_with_att", "proj_without_att", "proj_with_attM",
                    "proj_without_attM"):
            _linear(out, f"{name}.{sub}", p[name][sub])
        for sub in ("att_weight11", "att_weight22", "att_weight12",
                    "att_weightM"):
            out[f"{name}.{sub}"] = _a(p[name][sub])
        _bn(out, f"{name}.bn", p[name]["bn"], s[name].get("bn"))
    for name in ("pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2",
                 "pool_hT2"):
        _linear(out, f"{name}.proj", p[name]["proj"])
    _linear(out, "out_layer", p["out_layer"])
    return out


def _tensors(arrays: Mapping) -> Dict[str, torch.Tensor]:
    # np.array copies: a writable, contiguous array that keeps 0-d shapes
    # (np.ascontiguousarray would turn num_batches_tracked into shape (1,))
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def xlsr_state_dict_from_flax(params: Mapping, cfg: XLSRConfig
                              ) -> Dict[str, torch.Tensor]:
    """XLSREncoder params -> state dict for the port's XLSREncoder."""
    return _tensors(xlsr_arrays_from_flax(params, cfg))


def state_dict_from_flax(variables: Mapping,
                         xlsr_cfg: Optional[XLSRConfig] = None
                         ) -> Dict[str, torch.Tensor]:
    """AModel variables ({"params", "batch_stats"} of numpy arrays) ->
    state dict for the port's AModel."""
    return _tensors(amodel_arrays_from_flax(variables, xlsr_cfg))


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict file in the reference's naming (for example one
    written by `occm-export-model`): unwraps {"model": ...} and
    DataParallel's "module." prefix. A conv feature-extractor layer saved
    without a bias (a bias-free checkpoint, or an export that dropped an
    all-zero bias) gets a zero bias, so the port's modules load it
    strictly."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    for k, w in list(state.items()):
        if re.search(r"feature_extractor\.conv_layers\.\d+\.0\.weight$", k):
            state.setdefault(k[: -len("weight")] + "bias",
                             torch.zeros(w.shape[0], dtype=w.dtype))
    return state


def optimizer_state_from_flax(opt_state, xlsr_cfg: Optional[XLSRConfig] = None
                              ) -> Dict:
    """A JAX optimizer state of an AModel -> {"count": int, "mu": {name:
    tensor}, "nu": {name: tensor}} in the port's parameter names, with the
    parameters' transposes.

    opt_state: the JAX package's `FusedAdamState` (count, mu, nu), or
    optax adam's state, whose first element is a `ScaleByAdamState`; its
    mu and nu are parameter-shaped trees of numpy arrays. The positional
    conv is the one place the two parametrisations differ: JAX trains its
    folded kernel w, the port (as fairseq) trains the weight-norm pair
    (g, v). The moments of w go to weight_v (v = w at the bridge) and
    weight_g gets none (zero moments), so the positional conv's first
    update after a bridge is not JAX's."""
    adam = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    out: Dict = {"count": int(np.asarray(adam.count))}
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        arrays = amodel_arrays_from_flax({"params": tree}, xlsr_cfg,
                                         params_only=True)
        arrays.pop("ssl_model.model.encoder.pos_conv.0.weight_g")
        out[key] = _tensors(arrays)
    return out
