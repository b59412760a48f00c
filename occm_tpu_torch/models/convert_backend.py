"""Reference-trained torch checkpoints -> the JAX package's Flax variable
trees, and orbax directories of such trees -> reference torch checkpoints
(the port's copy of `occm_tpu.models.convert_backend`; numpy and torch
only).

The reference saves bare torch state dicts per epoch: the full AModel
(`aasist_vocoded_{epoch}.pt`, reference: oc_training.py:401) and the pair
`ssl_vocoded_{epoch}.pt` / `senet34_vocoded_{epoch}.pt` (reference:
test_dataloader_v2.py:144-145); the fused ssl_resnet34 module and LCNN
convert too. `convert_model_state_dict` maps such a state dict to
{"params", "batch_stats"} as the JAX package lays them out (Linear [out,
in] -> Dense kernel [in, out], Conv2d OIHW -> HWIO, BatchNorm weight / bias
-> params scale / bias and running_mean / var -> batch_stats mean / var,
`num_batches_tracked` dropped; the reference's dead BatchNorms, AASIST's
`bn1` and LCNN's `group.bn`, dropped), the SSL half through
`convert_xlsr.convert_fairseq_state_dict`. `convert_model_file` saves it
as an orbax directory (`occm-convert-model`), which the JAX package
restores.

`export_model_file` (`occm-export-model`) restores an orbax directory (a
converter's save, a trainer epoch directory, or a bare parameter tree)
with `train.orbax.restore_tree` and writes the reference-named state dict
that `models.convert.state_dict_from_flax` makes of it, dropping an
all-zero conv feature-extractor bias as the JAX exporter does (the port's
extractor loads either strictly). `state_dict_from_path` is the one
reader of the CLIs' weight flags: a torch `.pt`, or an orbax directory.

    python -m occm_tpu_torch.cli.convert_model model.pt out_dir \
        [--kind auto|amodel|senet|lcnn|ssl|ssl_resnet34] [--tiny]
    python -m occm_tpu_torch.cli.export_model ckpt_dir out.pt \
        [--kind auto|amodel|senet|lcnn|ssl_resnet34] [--tiny]
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.models.convert import (
    detect_model_kind, detect_params_kind, load_reference_state_dict,
    state_dict_from_flax, xlsr_state_dict_from_flax)
from occm_tpu_torch.models.convert_xlsr import convert_fairseq_state_dict


def _np(v) -> np.ndarray:
    return np.asarray(
        v.detach().cpu().numpy() if hasattr(v, "detach") else v,
        dtype=np.float32)


def _strip_prefix(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    if any(k.startswith(prefix) for k in sd):
        return {(k[len(prefix):] if k.startswith(prefix) else k): v
                for k, v in sd.items()}
    return dict(sd)


class _SD:
    """A state dict (as fp32 numpy) that records which keys were taken."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {k: _np(v) for k, v in sd.items()}
        self.used: set = set()

    def take(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self, ignore_substrings: Tuple[str, ...] = ()) -> list:
        return sorted(k for k in self.sd
                      if k not in self.used
                      and not any(s in k for s in ignore_substrings)
                      and not k.endswith("num_batches_tracked"))


def _linear(sd: _SD, key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": sd.take(f"{key}.weight").T}
    if sd.has(f"{key}.bias"):
        out["bias"] = sd.take(f"{key}.bias")
    return out


def _conv2d(sd: _SD, key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": sd.take(f"{key}.weight").transpose(2, 3, 1, 0)}
    if sd.has(f"{key}.bias"):
        out["bias"] = sd.take(f"{key}.bias")
    return out


def _bn(sd: _SD, key: str) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of one BatchNorm1d / 2d."""
    return ({"scale": sd.take(f"{key}.weight"),
             "bias": sd.take(f"{key}.bias")},
            {"mean": sd.take(f"{key}.running_mean"),
             "var": sd.take(f"{key}.running_var")})


def _gat_layer(sd: _SD, key: str) -> Tuple[Dict, Dict]:
    """GraphAttentionLayer (reference models/sslassist.py:58-77)."""
    bn_p, bn_s = _bn(sd, f"{key}.bn")
    return {"att_proj": _linear(sd, f"{key}.att_proj"),
            "att_weight": sd.take(f"{key}.att_weight"),
            "proj_with_att": _linear(sd, f"{key}.proj_with_att"),
            "proj_without_att": _linear(sd, f"{key}.proj_without_att"),
            "bn": bn_p}, {"bn": bn_s}


def _htrg_layer(sd: _SD, key: str) -> Tuple[Dict, Dict]:
    """HtrgGraphAttentionLayer (reference models/sslassist.py:158-178)."""
    bn_p, bn_s = _bn(sd, f"{key}.bn")
    params = {name: _linear(sd, f"{key}.{name}") for name in (
        "proj_type1", "proj_type2", "att_proj", "att_projM")}
    for name in ("att_weight11", "att_weight22", "att_weight12",
                 "att_weightM"):
        params[name] = sd.take(f"{key}.{name}")
    for name in ("proj_with_att", "proj_without_att", "proj_with_attM",
                 "proj_without_attM"):
        params[name] = _linear(sd, f"{key}.{name}")
    params["bn"] = bn_p
    return params, {"bn": bn_s}


def convert_aasist_backend(sd: _SD) -> Tuple[Dict, Dict]:
    """The AASIST backend's keys (all but the SSL frontend) -> (params,
    batch_stats) of the JAX package's AASISTBackend."""
    params: Dict = {"LL": _linear(sd, "LL")}
    stats: Dict = {}
    params["first_bn"], stats["first_bn"] = _bn(sd, "first_bn")
    params["first_bn1"], stats["first_bn1"] = _bn(sd, "first_bn1")
    # RawNet2 encoder blocks (reference models/sslassist.py:457-463); the
    # dead pre-activation bn1 (i >= 1) is dropped
    for i in range(6):
        base = f"encoder.{i}.0"
        block: Dict = {"conv1": _conv2d(sd, f"{base}.conv1")}
        block["bn2"], bn_s = _bn(sd, f"{base}.bn2")
        block["conv2"] = _conv2d(sd, f"{base}.conv2")
        if sd.has(f"{base}.conv_downsample.weight"):
            block["conv_downsample"] = _conv2d(sd, f"{base}.conv_downsample")
        params[f"encoder_{i}"] = block
        stats[f"encoder_{i}"] = {"bn2": bn_s}
    params["att_conv1"] = _conv2d(sd, "attention.0")
    params["att_bn"], stats["att_bn"] = _bn(sd, "attention.2")
    params["att_conv2"] = _conv2d(sd, "attention.3")
    for name in ("pos_S", "master1", "master2"):
        params[name] = sd.take(name)
    for name in ("GAT_layer_S", "GAT_layer_T"):
        params[name], stats[name] = _gat_layer(sd, name)
    for name in ("HtrgGAT_layer_ST11", "HtrgGAT_layer_ST12",
                 "HtrgGAT_layer_ST21", "HtrgGAT_layer_ST22"):
        params[name], stats[name] = _htrg_layer(sd, name)
    for name in ("pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2",
                 "pool_hT2"):
        params[name] = {"proj": _linear(sd, f"{name}.proj")}
    params["out_layer"] = _linear(sd, "out_layer")
    return params, stats


def convert_amodel_state_dict(sd: Mapping[str, Any],
                              xlsr_cfg: Optional[XLSRConfig] = None,
                              cfg: AASISTConfig = AASISTConfig()) -> Dict:
    """A full AModel checkpoint (`aasist_vocoded_{epoch}.pt`) ->
    {"params", "batch_stats"} of the JAX package's AModel."""
    sd = _strip_prefix(sd, "module.")  # DataParallel-wrapped saves
    ssl_sd = {k[len("ssl_model.model."):]: v for k, v in sd.items()
              if k.startswith("ssl_model.model.")}
    back = _SD({k: v for k, v in sd.items()
                if not k.startswith("ssl_model.")})
    ssl_params = convert_fairseq_state_dict(ssl_sd, xlsr_cfg or XLSRConfig())
    back_params, back_stats = convert_aasist_backend(back)
    unused = back.unused(ignore_substrings=(".bn1.",))
    if unused:
        raise ValueError(f"unconverted AModel keys: {unused[:8]}")
    return {"params": {"ssl_model": ssl_params, "backend": back_params},
            "batch_stats": {"backend": back_stats}}


def _se_block(sd: _SD, key: str) -> Tuple[Dict, Dict]:
    params: Dict = {"conv1": _conv2d(sd, f"{key}.conv1")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _bn(sd, f"{key}.bn1")
    params["conv2"] = _conv2d(sd, f"{key}.conv2")
    params["bn2"], stats["bn2"] = _bn(sd, f"{key}.bn2")
    params["se"] = {"fc1": _linear(sd, f"{key}.se.fc.0"),
                    "fc2": _linear(sd, f"{key}.se.fc.2")}
    if sd.has(f"{key}.downsample.0.weight"):
        params["downsample_conv"] = _conv2d(sd, f"{key}.downsample.0")
        params["downsample_bn"], stats["downsample_bn"] = _bn(
            sd, f"{key}.downsample.1")
    return params, stats


def convert_senet_state_dict(sd: Mapping[str, Any],
                             layers: Optional[Tuple[int, ...]] = None
                             ) -> Dict:
    """An SE-ResNet checkpoint (`senet34_vocoded_{epoch}.pt`) ->
    {"params", "batch_stats"} of the JAX package's SEResNet; the stage
    depths default to the checkpoint's own."""
    sd = _strip_prefix(sd, "module.")
    if layers is None:
        layers = tuple(1 + max(int(k.split(".")[1]) for k in sd
                               if k.startswith(f"layer{s}."))
                       for s in range(1, 5))
    v = _SD(sd)
    params: Dict = {"conv1": _conv2d(v, "conv1")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _bn(v, "bn1")
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            params[f"layer{stage}_{b}"], stats[f"layer{stage}_{b}"] = \
                _se_block(v, f"layer{stage}.{b}")
    params["embedding"] = _linear(v, "embedding")
    params["classifier"] = _linear(v, "classifier")
    unused = v.unused()
    if unused:
        raise ValueError(f"unconverted SE-ResNet keys: {unused[:8]}")
    return {"params": params, "batch_stats": stats}


def convert_ssl_resnet34_state_dict(sd: Mapping[str, Any],
                                    xlsr_cfg: Optional[XLSRConfig] = None
                                    ) -> Dict:
    """The fused ssl_resnet34 module's state dict (`frontend.model.*` +
    `resnet34.*`, reference: models/senet.py:162-170) -> {"params",
    "batch_stats"} of the JAX package's SSLResNet34."""
    sd = _strip_prefix(sd, "module.")
    ssl_sd = {k[len("frontend.model."):]: v for k, v in sd.items()
              if k.startswith("frontend.model.")}
    resnet_sd = {k[len("resnet34."):]: v for k, v in sd.items()
                 if k.startswith("resnet34.")}
    if len(ssl_sd) + len(resnet_sd) != len(sd):
        extra = [k for k in sd
                 if not k.startswith(("frontend.model.", "resnet34."))]
        raise ValueError(f"unconverted ssl_resnet34 keys: {extra[:8]}")
    resnet = convert_senet_state_dict(resnet_sd)
    return {"params": {"frontend": convert_fairseq_state_dict(
                           ssl_sd, xlsr_cfg or XLSRConfig()),
                       "resnet34": resnet["params"]},
            "batch_stats": {"resnet34": resnet["batch_stats"]}}


def convert_ssl_state_dict(sd: Mapping[str, Any],
                           xlsr_cfg: Optional[XLSRConfig] = None) -> Dict:
    """An SSLModel checkpoint (`ssl_vocoded_{epoch}.pt`, keys
    `model.<fairseq>`) -> the bare XLSREncoder parameters."""
    return {"params": convert_fairseq_state_dict(
                _strip_prefix(sd, "module."), xlsr_cfg or XLSRConfig()),
            "batch_stats": {}}


def convert_lcnn_state_dict(sd: Mapping[str, Any]) -> Dict:
    """An LCNN checkpoint -> {"params", "batch_stats"} of the JAX
    package's LCNN (the dead `group.bn`, reference models/lcnn.py:141,
    dropped)."""
    v = _SD(_strip_prefix(sd, "module."))
    params: Dict = {"layer1_mfm": {"filter": _conv2d(v, "layer1.0.filter")}}
    stats: Dict = {}
    for name in ("layer2", "layer3"):
        params[f"{name}_group"] = {
            "conv_a": {"filter": _conv2d(v, f"{name}.0.conv_a.filter")},
            "conv": {"filter": _conv2d(v, f"{name}.0.conv.filter")}}
        params[f"{name}_bn"], stats[f"{name}_bn"] = _bn(v, f"{name}.2")
    for name in ("fc0", "fc1", "fc2"):
        # mfm type 0 wraps its Linear as Sequential(Linear, Dropout)
        params[name] = {"filter": _linear(v, f"{name}.0.filter.0")}
    if v.has("fc3.weight") and not v.has("fc3.bias"):
        # AngleLinear: [in, out], no transpose, no bias (lcnn.py:28)
        params["fc3"] = {"weight": v.take("fc3.weight")}
    else:
        params["fc3"] = _linear(v, "fc3")
    unused = v.unused(ignore_substrings=(".0.bn.",))
    if unused:
        raise ValueError(f"unconverted LCNN keys: {unused[:8]}")
    return {"params": params, "batch_stats": stats}


def convert_model_state_dict(sd: Mapping[str, Any], kind: str = "auto",
                             xlsr_cfg: Optional[XLSRConfig] = None) -> Dict:
    """A reference torch state dict through its converter: {"params",
    "batch_stats", "_kind"} (the kind detected, or the one given)."""
    if kind == "auto":
        kind = detect_model_kind(sd)
    convert = {
        "amodel": lambda: convert_amodel_state_dict(sd, xlsr_cfg=xlsr_cfg),
        "senet": lambda: convert_senet_state_dict(sd),
        "lcnn": lambda: convert_lcnn_state_dict(sd),
        "ssl": lambda: convert_ssl_state_dict(sd, xlsr_cfg=xlsr_cfg),
        "ssl_resnet34": lambda: convert_ssl_resnet34_state_dict(
            sd, xlsr_cfg=xlsr_cfg),
    }[kind]
    out = convert()
    out["_kind"] = kind
    return out


def convert_model_file(pt_path: str, out_path: str, kind: str = "auto",
                       xlsr_cfg: Optional[XLSRConfig] = None) -> str:
    """A reference .pt state dict, converted and saved as an orbax
    directory holding {"params", "batch_stats"}; returns the kind."""
    from occm_tpu_torch.train.orbax import save_tree

    out = convert_model_state_dict(load_reference_state_dict(pt_path),
                                   kind=kind, xlsr_cfg=xlsr_cfg)
    kind = out.pop("_kind")
    save_tree(out, out_path)
    return kind


def variables_from_orbax(path: str) -> Dict:
    """{"params", "batch_stats"} of an orbax directory: a converter's save
    or a trainer epoch / step directory (its params and batch_stats; the
    optimizer state and step are left), or a bare parameter tree (no
    statistics)."""
    from occm_tpu_torch.train.orbax import restore_tree

    tree = restore_tree(path)
    if isinstance(tree, dict) and "params" in tree:
        return {"params": tree["params"],
                "batch_stats": tree.get("batch_stats") or {}}
    return {"params": tree, "batch_stats": {}}


_EXTRACTOR_BIAS = re.compile(r"(^|\.)feature_extractor\.conv_layers\.\d+\.0\."
                             r"bias$")


def export_model_file(ckpt_path: str, out_pt: str, kind: str = "auto",
                      xlsr_cfg: Optional[XLSRConfig] = None) -> str:
    """An orbax directory (a converter's save, a bare parameter tree, or a
    trainer checkpoint) torch.saved under the reference's state-dict
    naming, as the JAX package's exporters write it: `state_dict_from_flax`
    with an all-zero conv feature-extractor bias left out (a bias-free
    checkpoint). Returns the kind."""
    variables = variables_from_orbax(ckpt_path)
    got = detect_params_kind(variables["params"])
    if kind not in ("auto", got):
        raise ValueError(f"the tree holds a {got} model, not {kind}")
    sd = state_dict_from_flax(variables, xlsr_cfg or XLSRConfig())
    torch.save({k: v for k, v in sd.items()
                if not (_EXTRACTOR_BIAS.search(k) and not v.any())}, out_pt)
    return got


def state_dict_from_path(path: str, xlsr_cfg: Optional[XLSRConfig] = None,
                         into: Optional[torch.nn.Module] = None
                         ) -> Dict[str, torch.Tensor]:
    """The reference-named state dict of a weight flag's argument: a torch
    .pt (`load_reference_state_dict`), or an orbax directory of the JAX
    package through the bridge (`models.convert`). A directory of a bare
    XLSREncoder tree (an ssl conversion, `occm-convert-xlsr`) gives the
    encoder's names, prefixed `model.` when `into` is an SSLModel. A tree
    without batch_stats (a bare parameter tree) takes the BatchNorm
    statistics, and the reference's dead BatchNorms, from `into`, the
    module it is for, as the JAX CLIs keep their init's."""
    from occm_tpu_torch.models.convert import _tensors, arrays_from_flax
    from occm_tpu_torch.models.xlsr import SSLModel
    from occm_tpu_torch.train.orbax import is_orbax_dir

    if not is_orbax_dir(path):
        return load_reference_state_dict(path)
    variables = variables_from_orbax(path)
    xlsr_cfg = xlsr_cfg or XLSRConfig()
    if "feature_extractor" in variables["params"]:
        prefix = "model." if isinstance(into, SSLModel) else ""
        return {prefix + k: v for k, v in xlsr_state_dict_from_flax(
            variables["params"], xlsr_cfg).items()}
    if variables["batch_stats"] or into is None:
        return state_dict_from_flax(variables, xlsr_cfg)
    sd = {k: v.detach().cpu().clone() for k, v in into.state_dict().items()}
    params = _tensors(arrays_from_flax(variables, xlsr_cfg,
                                       params_only=True))
    unknown = sorted(set(params) - set(sd))
    if unknown:
        raise ValueError(f"{path}: parameters the model lacks: "
                         f"{unknown[:8]}")
    sd.update(params)
    return sd


def main_export(argv=None) -> None:
    """`occm-export-model` of the port: orbax directory -> reference .pt."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Export an orbax checkpoint of the JAX package (trainer "
        "epoch dir or converter output) to a reference-named torch .pt "
        "state dict")
    ap.add_argument("ckpt_path")
    ap.add_argument("out_pt")
    ap.add_argument("--kind", default="auto",
                    choices=("auto", "amodel", "senet", "lcnn",
                             "ssl_resnet34"))
    ap.add_argument("--tiny", action="store_true",
                    help="export against XLSRConfig.tiny() (test ckpts)")
    args = ap.parse_args(argv)
    xlsr_cfg = XLSRConfig.tiny() if args.tiny else XLSRConfig()
    kind = export_model_file(args.ckpt_path, args.out_pt, kind=args.kind,
                             xlsr_cfg=xlsr_cfg)
    print(f"exported {args.ckpt_path} ({kind}) -> {args.out_pt}")


def main(argv=None) -> None:
    """`occm-convert-model` of the port: reference .pt -> orbax
    directory."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a reference-trained torch checkpoint "
        "(aasist_vocoded_*.pt / senet34_vocoded_*.pt / ssl_vocoded_*.pt / "
        "LCNN) into an orbax checkpoint of the JAX package's layout")
    ap.add_argument("pt_path")
    ap.add_argument("out_path")
    ap.add_argument("--kind", default="auto",
                    choices=("auto", "amodel", "senet", "lcnn", "ssl",
                             "ssl_resnet34"))
    ap.add_argument("--tiny", action="store_true",
                    help="convert against XLSRConfig.tiny() (test ckpts)")
    args = ap.parse_args(argv)
    xlsr_cfg = XLSRConfig.tiny() if args.tiny else XLSRConfig()
    kind = convert_model_file(args.pt_path, args.out_path, kind=args.kind,
                              xlsr_cfg=xlsr_cfg)
    print(f"converted {args.pt_path} ({kind}) -> {args.out_path}")


if __name__ == "__main__":
    main()
