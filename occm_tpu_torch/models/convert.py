"""The weight bridge: Flax variables of the JAX package's models -> a
state dict in the reference's torch naming, which the port's modules load
with `load_state_dict(strict=True)`.

This is the port's own copy of the mapping of
`occm_tpu.models.convert_backend`'s exporters (`export_xlsr_state_dict`,
`export_amodel_state_dict`, `export_senet_state_dict`,
`export_lcnn_state_dict`, and `export_model_file`'s fused ssl_resnet34
layout), extended to the JAX package's other fused models (SSLLCNN,
TotalCNNNet, OCCM; the CNN named as its Flax scopes) and dispatched on a
tree's top-level names as `detect_params_kind` does. Both extractor modes
map: "layer_norm" (`ln_{i}` -> `conv_layers.{i}.2.1`) and "default", the
wav2vec2-base layout (`gn_0` -> `conv_layers.0.2`). One difference: the
export drops a conv feature-extractor bias that is all zeros (a bias-free
reference checkpoint), while the bridge always emits it; the port's
extractor loads either strictly (a missing bias loads as zeros). Dead
reference BatchNorms (AASIST's `bn1`, LCNN's `group.bn`) are emitted at
torch's defaults. Inputs are plain numpy
arrays, so the port needs no JAX to read a tree that was saved to disk.
`detect_model_kind` is the port's copy of the JAX package's: it tells the
reference's checkpoint files apart by their key names.

Layouts: Flax Dense kernel [in, out] -> Linear weight [out, in]; Flax
Conv kernel [K, in, out] -> Conv1d [out, in, K]; Flax Conv HWIO ->
Conv2d OIHW. The positional conv is split into fairseq's weight norm with
g = the norm over axes (0, 1) of v = w [C, C/G, K], which PosConv folds
back into the kernel w it trains.
"""

from __future__ import annotations

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


def _layer_linear(out: Dict, key: str, p: Mapping, l: int) -> None:
    """Layer l of a scan-stacked Dense: {kernel [L, in, out], bias}, or the
    quant_int8 layout {kernel_q int8 [L, in, out], scale, bias} ->
    weight_q int8 [out, in], scale and bias fp32."""
    if "kernel_q" in p:
        out[f"{key}.weight_q"] = np.ascontiguousarray(
            np.asarray(p["kernel_q"], np.int8)[l].T)
        out[f"{key}.scale"] = _a(p["scale"])[l]
        out[f"{key}.bias"] = _a(p["bias"])[l]
    else:
        _linear(out, key, {"kernel": _a(p["kernel"])[l],
                           "bias": _a(p["bias"])[l]})


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
    """XLSREncoder params -> {fairseq wav2vec2 name: numpy array}; a tree
    in the quant_int8 layout (`quantize_params_int8`'s) maps to the port's
    Int8Linear names."""
    out: Dict = {}
    fe = params["feature_extractor"]
    for i, (dim, _, _) in enumerate(cfg.conv_layers):
        conv = fe[f"conv_{i}"]
        out[f"feature_extractor.conv_layers.{i}.0.weight"] = _a(
            conv["kernel"]).transpose(2, 1, 0)
        out[f"feature_extractor.conv_layers.{i}.0.bias"] = (
            _a(conv["bias"]) if "bias" in conv else np.zeros(dim, np.float32))
        if cfg.extractor_mode == "layer_norm":
            norm, key = fe[f"ln_{i}"], f"{i}.2.1"
        elif i == 0:
            norm, key = fe["gn_0"], "0.2"
        else:
            continue
        out[f"feature_extractor.conv_layers.{key}.weight"] = _a(norm["scale"])
        out[f"feature_extractor.conv_layers.{key}.bias"] = _a(norm["bias"])

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
            _layer_linear(out, f"{base}.self_attn.{name}",
                          layer["self_attn"][name], l)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            out[f"{base}.{name}.weight"] = _a(layer[name]["scale"])[l]
            out[f"{base}.{name}.bias"] = _a(layer[name]["bias"])[l]
        for name in ("fc1", "fc2"):
            _layer_linear(out, f"{base}.{name}", layer[name], l)

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


def _se_block(out: Dict, key: str, p: Mapping, s) -> None:
    _conv2d(out, f"{key}.conv1", p["conv1"])
    _bn(out, f"{key}.bn1", p["bn1"], s.get("bn1"))
    _conv2d(out, f"{key}.conv2", p["conv2"])
    _bn(out, f"{key}.bn2", p["bn2"], s.get("bn2"))
    _linear(out, f"{key}.se.fc.0", p["se"]["fc1"])
    _linear(out, f"{key}.se.fc.2", p["se"]["fc2"])
    if "downsample_conv" in p:
        _conv2d(out, f"{key}.downsample.0", p["downsample_conv"])
        _bn(out, f"{key}.downsample.1", p["downsample_bn"],
            s.get("downsample_bn"))


def senet_arrays_from_flax(p: Mapping, s) -> Dict:
    """SEResNet params and batch_stats -> reference models/senet.py names
    (`export_senet_state_dict`; stage depths read off the tree)."""
    out: Dict = {}
    _conv2d(out, "conv1", p["conv1"])
    _bn(out, "bn1", p["bn1"], s.get("bn1"))
    for name in sorted((k for k in p if k.startswith("layer")),
                       key=lambda k: tuple(map(int, k[5:].split("_")))):
        stage, b = name[5:].split("_")
        _se_block(out, f"layer{stage}.{b}", p[name], s[name])
    _linear(out, "embedding", p["embedding"])
    _linear(out, "classifier", p["classifier"])
    return out


def lcnn_arrays_from_flax(p: Mapping, s) -> Dict:
    """LCNN params and batch_stats -> reference models/lcnn.py names
    (`export_lcnn_state_dict`; the dead `group.bn` at torch's defaults,
    left out of a parameter-only mapping, whose `s` has no statistics)."""
    out: Dict = {}
    _conv2d(out, "layer1.0.filter", p["layer1_mfm"]["filter"])
    for name in ("layer2", "layer3"):
        grp = p[f"{name}_group"]
        _conv2d(out, f"{name}.0.conv_a.filter", grp["conv_a"]["filter"])
        if s.get(f"{name}_bn") is not None:
            _bn_default(out, f"{name}.0.bn",
                        _a(grp["conv_a"]["filter"]["kernel"]).shape[2])
        _conv2d(out, f"{name}.0.conv.filter", grp["conv"]["filter"])
        _bn(out, f"{name}.2", p[f"{name}_bn"], s.get(f"{name}_bn"))
    for name in ("fc0", "fc1", "fc2"):
        _linear(out, f"{name}.0.filter.0", p[name]["filter"])
    if "weight" in p["fc3"]:  # AngleLinear: [in, out], no transpose, no bias
        out["fc3.weight"] = _a(p["fc3"]["weight"])
    else:
        _linear(out, "fc3", p["fc3"])
    return out


def cnn_arrays_from_flax(p: Mapping, s) -> Dict:
    """A CNN of `models.cnn` -> the port's names (the Flax scopes)."""
    out: Dict = {}
    for name in sorted(p):
        if name.startswith(("conv", "fc")):
            (_conv2d if name.startswith("conv") else _linear)(out, name,
                                                              p[name])
        elif name.startswith("bn"):
            _bn(out, name, p[name], s.get(name))
        elif name.startswith("attention"):
            _conv2d(out, f"{name}.conv", p[name]["conv"])
    return out


def detect_params_kind(params: Mapping) -> str:
    """Which model a Flax params tree belongs to, by its top-level names
    (the JAX package's `detect_params_kind`, with the fused models it
    does not export)."""
    keys = set(params)
    if {"ssl_model", "backend"} <= keys:
        return "amodel"
    if "frontend" in keys:
        for kind, backends in (("occm", {"senet34_branch", "lcnn_branch"}),
                               ("ssl_resnet34", {"resnet34"}),
                               ("ssl_lcnn", {"lcnn"}),
                               ("cnn", {"cnn_net"})):
            if backends <= keys:
                return kind
    if "layer1_mfm" in keys:
        return "lcnn"
    if "embedding" in keys and "classifier" in keys:
        return "senet"
    if "conv1" in keys and "fc3" in keys:
        return "cnn_backend"
    raise ValueError(
        f"unrecognised params tree (top-level: {sorted(keys)[:8]})")


#: the fused models' backend scopes and their mappings
_BACKENDS = {"resnet34": senet_arrays_from_flax,
             "senet34_branch": senet_arrays_from_flax,
             "lcnn": lcnn_arrays_from_flax,
             "lcnn_branch": lcnn_arrays_from_flax,
             "cnn_net": cnn_arrays_from_flax}


def arrays_from_flax(variables: Mapping,
                     xlsr_cfg: Optional[XLSRConfig] = None,
                     params_only: bool = False) -> Dict:
    """Variables of any model the bridge knows ({"params", "batch_stats"};
    see `detect_params_kind`) -> {reference torch name: numpy array}. With
    params_only, only the trainable parameters that the Flax tree has (see
    `amodel_arrays_from_flax`)."""
    p = variables["params"]
    kind = detect_params_kind(p)
    if kind == "amodel":
        return amodel_arrays_from_flax(variables, xlsr_cfg, params_only)
    s = _NoStats() if params_only else variables.get("batch_stats", {})
    bare = {"senet": senet_arrays_from_flax, "lcnn": lcnn_arrays_from_flax,
            "cnn_backend": cnn_arrays_from_flax}
    if kind in bare:
        return bare[kind](p, s)
    out: Dict = {
        f"frontend.model.{k}": v for k, v in xlsr_arrays_from_flax(
            p["frontend"], xlsr_cfg or XLSRConfig()).items()}
    for scope in _BACKENDS:
        if scope in p:
            out.update({f"{scope}.{k}": v for k, v in
                        _BACKENDS[scope](p[scope], s[scope]).items()})
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
    """Variables ({"params", "batch_stats"} of numpy arrays) of an AModel,
    SSLResNet34, SSLLCNN, TotalCNNNet, OCCM, or of a bare SEResNet, LCNN
    or CNN -> state dict for the port's module of that name."""
    return _tensors(arrays_from_flax(variables, xlsr_cfg))


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict file in the reference's naming (for example one
    written by `occm-export-model`): unwraps {"model": ...} and
    DataParallel's "module." prefix. A conv feature-extractor layer saved
    without a bias (a bias-free checkpoint such as wav2vec2-base's, or an
    export that dropped an all-zero bias) stays so: the port's extractor
    loads it strictly, with a zero bias."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


#: the JAX package's optimizer states (`occm_tpu.train.loop.make_optimizer`)
#: by the name `flax_optimizer_form` gives them
FLAX_OPTIMIZER_FORMS = {
    "fused_adam": "FusedAdamState {count, mu, nu} (--optimizer fused_adam)",
    "adam": "optax adam with a constant lr [{count, mu, nu}, None] "
            "(--optimizer adam --lr_schedule constant)",
    "adam_schedule": "optax adam under an lr schedule [{count, mu, nu}, "
                     "{count}] (--optimizer adam --lr_schedule cosine or "
                     "linear)"}


def _adam_fields(x) -> Optional[tuple]:
    """(count, mu, nu) of a ScaleByAdamState / FusedAdamState, or of the
    dict orbax restores one as without a template; else None."""
    if isinstance(x, Mapping):
        if set(x) == {"count", "mu", "nu"}:
            return x["count"], x["mu"], x["nu"]
        return None
    if all(hasattr(x, a) for a in ("count", "mu", "nu")):
        return x.count, x.mu, x.nu
    return None


def flax_optimizer_form(opt_state) -> tuple:
    """(form, (count, mu, nu), schedule count or None) of a JAX optimizer
    state, in any of the forms below; form is a key of
    FLAX_OPTIMIZER_FORMS. Raises ValueError for anything else.

    - "fused_adam": `FusedAdam`'s FusedAdamState(count, mu, nu), restored
      untemplated as {count, mu, nu};
    - "adam": `optax.adam(lr)`'s (ScaleByAdamState, EmptyState), restored
      as [{count, mu, nu}, None];
    - "adam_schedule": `optax.adam(schedule)`'s (ScaleByAdamState,
      ScaleByScheduleState), restored as [{count, mu, nu}, {count}].
    """
    adam = _adam_fields(opt_state)
    if adam is not None:
        return "fused_adam", adam, None
    if isinstance(opt_state, (list, tuple)) and len(opt_state) == 2:
        adam = _adam_fields(opt_state[0])
        tail = opt_state[1]
        if adam is not None:
            if tail is None or (isinstance(tail, tuple) and not tail):
                return "adam", adam, None  # orbax's None, optax's EmptyState
            if isinstance(tail, Mapping) and set(tail) == {"count"}:
                return "adam_schedule", adam, int(np.asarray(tail["count"]))
            if hasattr(tail, "count") and len(tail) == 1:
                return "adam_schedule", adam, int(np.asarray(tail.count))
    raise ValueError(
        "not an optimizer state of the JAX package (one of: "
        + "; ".join(FLAX_OPTIMIZER_FORMS.values())
        + f"); got {_shape_of(opt_state)}")


def _shape_of(tree) -> str:
    """A short description of a tree's containers, for errors."""
    if isinstance(tree, Mapping):
        return "{" + ", ".join(sorted(map(str, tree))) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_shape_of(x) for x in tree) + "]"
    return type(tree).__name__


def optimizer_state_from_flax(opt_state, xlsr_cfg: Optional[XLSRConfig] = None
                              ) -> Dict:
    """A JAX optimizer state of any model `state_dict_from_flax` takes ->
    {"count": int, "mu": {name: tensor}, "nu": {name: tensor}} in the
    port's parameter names, with the parameters' transposes: the form
    `TrainState.load_optimizer_state` takes under either optimizer
    (torch.optim.Adam, capturable on a card, and FusedAdam).

    opt_state: any form of `flax_optimizer_form`, as the JAX objects or as
    `train.orbax.restore_tree` gives them; mu and nu are parameter-shaped
    trees of numpy arrays. Under a schedule, the schedule's own count must
    be Adam's (ValueError otherwise). Both packages train the positional
    conv's folded kernel w, so w's moments go to
    `encoder.pos_conv.0.weight`."""
    _, (count, mu, nu), sched_count = flax_optimizer_form(opt_state)
    count = int(np.asarray(count))
    if sched_count is not None and sched_count != count:
        raise ValueError(f"the lr schedule's count {sched_count} is not "
                         f"Adam's count {count}")
    out: Dict = {"count": count}
    for key, tree in (("mu", mu), ("nu", nu)):
        arrays = arrays_from_flax({"params": tree}, xlsr_cfg,
                                  params_only=True)
        for name in [n for n in arrays
                     if n.endswith("encoder.pos_conv.0.weight_g")]:
            pos = name[: -len("weight_g")]
            arrays.pop(name)
            arrays[pos + "weight"] = arrays.pop(pos + "weight_v")
        out[key] = _tensors(arrays)
    return out


def detect_model_kind(sd: Mapping) -> str:
    """Which reference checkpoint family a torch state dict belongs to, by
    its key names (the port's copy of the JAX package's
    `detect_model_kind`): "amodel" (aasist_vocoded_*.pt), "ssl_resnet34"
    (the fused frontend.model.* + resnet34.* file), "senet"
    (senet34_vocoded_*.pt), "lcnn", or "ssl" (ssl_vocoded_*.pt, an
    SSLModel's model.*)."""
    probe = {k.split("module.", 1)[-1] for k in sd}
    if any(k.startswith("ssl_model.") for k in probe) or "pos_S" in probe:
        return "amodel"
    if any(k.startswith("frontend.model.") for k in probe) and any(
            k.startswith("resnet34.") for k in probe):
        return "ssl_resnet34"
    if any(k.startswith("layer4.") for k in probe) and \
            "embedding.weight" in probe:
        return "senet"
    if any(k.startswith("fc3.") for k in probe) and any(
            k.startswith("layer1.0.filter") for k in probe):
        return "lcnn"
    if any(k.startswith(("model.", "feature_extractor.")) for k in probe):
        return "ssl"
    raise ValueError(
        "unrecognised checkpoint: expected reference AModel "
        "(aasist_vocoded_*.pt), SE-ResNet (senet34_vocoded_*.pt), LCNN, or "
        "SSLModel (ssl_vocoded_*.pt) key names")
