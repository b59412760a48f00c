"""Pretrained wav2vec2 / XLS-R checkpoints into the port's SSL frontend
(the port's own copy of what `occm_tpu.models.convert_xlsr` does for the
training CLI's --pretrained_xlsr).

Reads a fairseq checkpoint (`xlsr2_300m.pt`: {"model": state dict, "cfg":
...}), a HuggingFace `transformers` Wav2Vec2 one (`pytorch_model.bin`, a
.pt state dict, or `model.safetensors`), or an orbax directory of encoder
parameters (what `occm-convert-xlsr` writes, read by `train.orbax`), and
loads its encoder into an `XLSREncoder` (`graft_pretrained_xlsr`) with
`load_state_dict(strict=True)`:
- fairseq wrapper prefixes are stripped: `w2v_encoder.w2v_model.`
  (fine-tuned checkpoints), `w2v_model.`, `model.`;
- HF names are renamed to fairseq's (`hf_to_fairseq_names`; HF's
  checkpoints were converted from fairseq, so layouts are identical);
- pretraining-only tensors are dropped (mask_emb, quantizer.*, project_q.*,
  final_proj.*, a fine-tuned model's CTC head w2v_encoder.proj.*, and HF's
  `_HF_IGNORED`): the reference runs features_only=True with mask=False
  (reference: models/xlsr.py:46);
- a conv feature-extractor layer without a bias (conv_bias=False, as
  in wav2vec2-base) loads as zeros (the extractor's load hook), as the
  JAX converter fills them; both extractor layouts graft, XLS-R's
  LayerNorm after every conv and base's GroupNorm after the first (HF's
  `conv_layers.0.layer_norm` becomes fairseq's `conv_layers.0.2`), and
  both encoder layouts (pre- and post-norm, whose `encoder.layer_norm`
  runs before the layers);
- the positional conv's weight-norm pair (weight_g, weight_v) is folded
  into the kernel the port trains by `PosConv`'s load hook.

A fairseq checkpoint pickles its cfg as an omegaconf `DictConfig` (older
ones an `argparse.Namespace`), which `torch.load(weights_only=True)`
rejects and `weights_only=False` can only read with omegaconf installed.
`read_checkpoint` unpickles with `_StubUnpickler` instead: torch's own
tensor and storage rebuilds and `collections.OrderedDict` are resolved,
and every other global (the cfg's classes, whether importable or not)
becomes an inert stub, so no code of the file's choosing runs and no
import is needed. The tensors, and the cfg's dropout rates
(`read_fairseq_dropout_rates`, from the stubs' pickled state), are all
that is read.

The converter to the JAX package's parameter tree is here too, as the
port's copy of `occm_tpu.models.convert_xlsr`: `convert_fairseq_state_dict`,
`convert_hf_state_dict`, `fold_weight_norm` (numpy, the JAX converter's
formula), and `convert_checkpoint_file` / `main` (`python -m
occm_tpu_torch.cli.convert_xlsr ckpt out_dir [--format] [--tiny]`), which
write the tree as an orbax directory that the JAX package restores.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import re
import types
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from occm_tpu_torch.config import XLSRConfig

FAIRSEQ_PREFIXES = ("w2v_encoder.w2v_model.", "w2v_model.", "model.")
PRETRAINING_ONLY = ("mask_emb", "quantizer.", "project_q.", "final_proj.",
                    "w2v_encoder.proj.")

_HF_RENAMES = (
    # HuggingFace transformers Wav2Vec2Model naming -> fairseq naming
    (".conv.parametrizations.weight.original0", ".0.weight_g"),
    (".conv.parametrizations.weight.original1", ".0.weight_v"),
    (".conv.weight_g", ".0.weight_g"),
    (".conv.weight_v", ".0.weight_v"),
    ("encoder.pos_conv_embed", "encoder.pos_conv"),
    ("feature_projection.layer_norm", "layer_norm"),
    ("feature_projection.projection", "post_extract_proj"),
    (".attention.", ".self_attn."),
    (".feed_forward.intermediate_dense", ".fc1"),
    (".feed_forward.output_dense", ".fc2"),
)

_HF_IGNORED = (
    "masked_spec_embed", "quantizer", "project_q", "project_hid", "adapter",
    "lm_head",
)

CHECKPOINT_SUFFIXES = (".pt", ".bin", ".safetensors")


def hf_to_fairseq_names(sd: Mapping, cfg: XLSRConfig) -> Dict:
    """Rename a HuggingFace `Wav2Vec2Model` state dict (or a wrapped head's,
    keys prefixed `wav2vec2.`) into fairseq naming, dropping `_HF_IGNORED`
    tensors."""
    out: Dict = {}
    for k, v in sd.items():
        if k.startswith("wav2vec2."):
            k = k[len("wav2vec2."):]
        if any(tok in k for tok in _HF_IGNORED):
            continue
        if k.startswith("feature_extractor.conv_layers."):
            # HF: .conv.* / .layer_norm.*; fairseq: .0.* / .2.1.*
            # (layer_norm mode) or .2.* (group norm on block 0)
            k = k.replace(".conv.", ".0.")
            ln_target = (".2.1." if cfg.extractor_mode == "layer_norm"
                         else ".2.")
            k = k.replace(".layer_norm.", ln_target)
        else:
            for old, new in _HF_RENAMES:
                k = k.replace(old, new)
            # HF's pre-attention LN is `layers.{l}.layer_norm` (fairseq:
            # self_attn_layer_norm); the top-level encoder.layer_norm stays
            k = re.sub(r"(\.layers\.\d+)\.layer_norm\.",
                       r"\1.self_attn_layer_norm.", k)
        k = k.replace("encoder.pos_conv.conv.", "encoder.pos_conv.0.")
        out[k] = v
    return out


def detect_format(sd: Mapping) -> str:
    """'hf' if the state dict uses transformers naming, else 'fairseq'."""
    for k in sd:
        if "feature_projection." in k or k.startswith("wav2vec2."):
            return "hf"
    return "fairseq"


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A .safetensors file as {name: numpy array}, read with numpy alone
    (8-byte little-endian header length, a JSON header, then the raw
    little-endian tensor bytes). BF16 tensors are widened to fp32 exactly
    (a bf16 value is the top half of its fp32 bit pattern)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        b0, b1 = meta["data_offsets"]
        dtype = meta["dtype"]
        if dtype == "BF16":
            half = np.frombuffer(data, np.dtype("<u2"), (b1 - b0) // 2, b0)
            arr = (half.astype(np.uint32) << 16).view(np.float32)
        elif dtype in _SAFETENSORS_DTYPES:
            dt = np.dtype(_SAFETENSORS_DTYPES[dtype]).newbyteorder("<")
            arr = np.frombuffer(data, dt, (b1 - b0) // dt.itemsize, b0)
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, "
                             "which this reader does not take")
        out[name] = arr.reshape(meta["shape"])
    return out


class _Stub:
    """Stands in for a pickled object of a class this reader does not
    resolve; keeps what the pickle hands it and does nothing else."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state

    def __setitem__(self, key, value):
        vars(self).setdefault("items", {})[key] = value

    def append(self, value):
        vars(self).setdefault("values", []).append(value)

    def extend(self, values):
        for v in values:
            self.append(v)


def _stub_class(module: str, name: str) -> type:
    cls = type(name, (_Stub,), {})
    cls.__module__ = module
    return cls


class _StubUnpickler(pickle.Unpickler):
    """Resolves what a torch state dict is made of (torch's `_rebuild_*`
    functions, dtypes, Size, device, Parameter, OrderedDict); any other
    global becomes a stub class."""

    def find_class(self, module, name):
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        if module == "torch" or module.startswith("torch."):
            obj = getattr(torch, name, None) if module == "torch" else None
            if (name.startswith("_rebuild") or name in (
                    "Size", "device", "Parameter", "Tensor")
                    or isinstance(obj, torch.dtype)):
                return super().find_class(module, name)
        return _stub_class(module, name)


# the pickle_module torch.load unpickles with (it reads Unpickler and load)
_STUB_PICKLE = types.ModuleType("occm_stub_pickle")
_STUB_PICKLE.Unpickler = _StubUnpickler
_STUB_PICKLE.load = pickle.load


def _read(path: str) -> Tuple[Dict[str, torch.Tensor], object]:
    """(flat state dict, the unpickled wrapper or None) of a checkpoint."""
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(v)
                for k, v in load_safetensors(path).items()}, None
    wrapper = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_STUB_PICKLE)
    state = wrapper
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    if not isinstance(state, dict):
        raise ValueError(f"{path}: not a state dict or a {{'model': state "
                         f"dict}} wrapper (a {type(state).__name__})")
    return dict(state), wrapper


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The flat state dict of a fairseq / HF checkpoint: a .safetensors
    file (numpy reader), or a torch pickle (.pt / .bin) unwrapped from
    {"model": ...}, its cfg read as stubs (see the module docstring)."""
    return _read(path)[0]


def _plain(obj):
    """A checkpoint cfg read through `_StubUnpickler` as plain dicts: a stub
    becomes its pickled state (an omegaconf DictConfig its `_content`, a
    value node its `_val`, an argparse.Namespace its attributes)."""
    if isinstance(obj, _Stub):
        state = vars(obj).get("state")
        if not isinstance(state, dict):
            return obj
        if "_content" in state:
            return _plain(state["_content"])
        if "_val" in state:
            return _plain(state["_val"])
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


#: dropout-site names shared by the fairseq model cfg and XLSRConfig
DROPOUT_FIELDS = ("dropout", "attention_dropout", "activation_dropout",
                  "dropout_input")


def read_fairseq_dropout_rates(state) -> Optional[Dict[str, float]]:
    """The live dropout rates of a fairseq checkpoint wrapper (the port's
    copy of the JAX converter's): {field: rate} for every XLSRConfig
    dropout field found in the modern `state["cfg"]["model"]` or the legacy
    `state["args"]` (plus `encoder_layerdrop` as `layerdrop`), or None
    where the wrapper carries no cfg. Takes the real objects (a mapping, an
    omegaconf DictConfig, an argparse.Namespace) and the stubs
    `read_checkpoint`'s unpickler makes of them. The reference runs the
    SSL frontend in train mode (reference: models/sslassist.py:24-48), so
    these rates were live in its fine-tunes."""
    state = _plain(state)
    model_cfg = None
    if isinstance(state, dict):
        cfg = state.get("cfg")
        if cfg is not None:
            try:
                model_cfg = cfg["model"] if "model" in cfg else None
            except TypeError:
                model_cfg = getattr(cfg, "model", None)
        if model_cfg is None and "args" in state:
            model_cfg = state["args"]
    if model_cfg is None:
        return None

    def get(name):
        try:
            if hasattr(model_cfg, name):
                return getattr(model_cfg, name)
            return model_cfg[name]
        except (KeyError, TypeError):
            return None

    rates = {}
    for field in DROPOUT_FIELDS:
        v = get(field)
        if v is not None:
            rates[field] = float(v)
    layerdrop = get("encoder_layerdrop")
    if layerdrop is not None:
        rates["layerdrop"] = float(layerdrop)
    return rates or None


def _print_rates(rates: Optional[Dict[str, float]]) -> None:
    if rates is not None:
        print("checkpoint cfg dropout rates (set the matching XLSRConfig "
              "fields to reproduce the reference's train-mode SSL "
              "regularization): "
              + ", ".join(f"{k}={v:g}" for k, v in sorted(rates.items())))


def encoder_state_dict(sd: Mapping[str, torch.Tensor],
                       cfg: XLSRConfig) -> Dict[str, torch.Tensor]:
    """A fairseq- or HF-named checkpoint state dict -> the state dict of
    the port's XLSREncoder (fairseq naming, pretraining-only tensors
    dropped; a missing conv bias stays missing and loads as zeros)."""
    if detect_format(sd) == "hf":
        sd = hf_to_fairseq_names(sd, cfg)
    sd = dict(sd)
    for prefix in FAIRSEQ_PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            sd = {(k[len(prefix):] if k.startswith(prefix) else k): v
                  for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not any(k.startswith(p) for p in PRETRAINING_ONLY)}


def _t(w) -> np.ndarray:
    return np.asarray(
        w.detach().cpu().numpy() if hasattr(w, "detach") else w,
        dtype=np.float32)


def fold_weight_norm(weight_g: np.ndarray, weight_v: np.ndarray,
                     dim: int = 2) -> np.ndarray:
    """w = g * v / ||v|| with the norm over all axes except `dim`
    (torch.nn.utils.weight_norm; fairseq's pos_conv uses dim=2), in numpy
    as the JAX converter computes it."""
    axes = tuple(i for i in range(weight_v.ndim) if i != dim)
    norm = np.sqrt(np.sum(weight_v**2, axis=axes, keepdims=True))
    return weight_g * weight_v / np.maximum(norm, 1e-12)


def convert_fairseq_state_dict(sd: Mapping, cfg: XLSRConfig) -> Dict:
    """A fairseq wav2vec2 state dict (torch tensors or numpy arrays) -> the
    JAX package's XLSREncoder parameter tree of fp32 numpy arrays (layers
    stacked on axis 0 for nn.scan, Dense kernels [in, out], conv kernels
    [K, in, out], the positional conv's weight norm folded); wrapper
    prefixes stripped, pretraining-only tensors ignored, a missing conv
    bias filled with zeros."""
    sd = {k: _t(v) for k, v in sd.items()}
    for prefix in FAIRSEQ_PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            sd = {(k[len(prefix):] if k.startswith(prefix) else k): v
                  for k, v in sd.items()}

    fe: Dict = {}
    for i in range(len(cfg.conv_layers)):
        conv_w = sd[f"feature_extractor.conv_layers.{i}.0.weight"]
        b = sd.get(f"feature_extractor.conv_layers.{i}.0.bias")
        fe[f"conv_{i}"] = {
            "kernel": conv_w.transpose(2, 1, 0),  # [out,in,k] -> [k,in,out]
            "bias": b if b is not None else np.zeros(conv_w.shape[0],
                                                     np.float32)}
        if cfg.extractor_mode == "layer_norm":
            fe[f"ln_{i}"] = {
                "scale": sd[f"feature_extractor.conv_layers.{i}.2.1.weight"],
                "bias": sd[f"feature_extractor.conv_layers.{i}.2.1.bias"]}
        elif i == 0:
            fe["gn_0"] = {
                "scale": sd["feature_extractor.conv_layers.0.2.weight"],
                "bias": sd["feature_extractor.conv_layers.0.2.bias"]}
    p: Dict = {"feature_extractor": fe,
               "layer_norm": {"scale": sd["layer_norm.weight"],
                              "bias": sd["layer_norm.bias"]}}
    if "post_extract_proj.weight" in sd:
        p["post_extract_proj"] = {
            "kernel": sd["post_extract_proj.weight"].T,
            "bias": sd["post_extract_proj.bias"]}

    w = fold_weight_norm(sd["encoder.pos_conv.0.weight_g"],
                         sd["encoder.pos_conv.0.weight_v"], dim=2)
    p["pos_conv"] = {"kernel": w.transpose(2, 1, 0),  # -> [k, in/g, out]
                     "bias": sd["encoder.pos_conv.0.bias"]}

    def stack(fmt: str, transpose: bool = False) -> np.ndarray:
        ws = [sd[fmt.format(l=l)] for l in range(cfg.encoder_layers)]
        return np.stack([w.T for w in ws] if transpose else ws, axis=0)

    base = "encoder.layers.{l}."
    layer = {
        "self_attn": {
            name: {"kernel": stack(f"{base}self_attn.{name}.weight", True),
                   "bias": stack(f"{base}self_attn.{name}.bias")}
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
    }
    for name in ("self_attn_layer_norm", "final_layer_norm"):
        layer[name] = {"scale": stack(f"{base}{name}.weight"),
                       "bias": stack(f"{base}{name}.bias")}
    for name in ("fc1", "fc2"):
        layer[name] = {"kernel": stack(f"{base}{name}.weight", True),
                       "bias": stack(f"{base}{name}.bias")}
    p["layers"] = {"layer": {k: layer[k] for k in (
        "self_attn", "self_attn_layer_norm", "fc1", "fc2",
        "final_layer_norm")}}
    p["encoder_layer_norm"] = {"scale": sd["encoder.layer_norm.weight"],
                               "bias": sd["encoder.layer_norm.bias"]}
    return p


def convert_hf_state_dict(sd: Mapping, cfg: XLSRConfig) -> Dict:
    """A HuggingFace Wav2Vec2Model state dict -> the same parameter tree as
    `convert_fairseq_state_dict` (renamed by `hf_to_fairseq_names`)."""
    return convert_fairseq_state_dict(hf_to_fairseq_names(sd, cfg), cfg)


def convert_checkpoint_file(pt_path: str, out_path: str,
                            cfg: XLSRConfig = XLSRConfig(),
                            fmt: str = "auto") -> Optional[Dict[str, float]]:
    """A fairseq / HF checkpoint (.pt, .bin, .safetensors) converted and
    saved as an orbax directory of the encoder's parameter tree (what the
    JAX package's `occm-convert-xlsr` writes). Returns, and prints, the
    dropout rates of a fairseq checkpoint's cfg."""
    from occm_tpu_torch.train.orbax import save_tree

    sd, wrapper = _read(pt_path)
    rates = read_fairseq_dropout_rates(wrapper)
    if fmt == "auto":
        fmt = detect_format(sd)
    convert = convert_hf_state_dict if fmt == "hf" else \
        convert_fairseq_state_dict
    save_tree(convert(sd, cfg), out_path)
    _print_rates(rates)
    return rates


def graft_pretrained_xlsr(encoder: torch.nn.Module,
                          path: str) -> Optional[Dict[str, float]]:
    """Load the checkpoint at `path` (.pt / .bin / .safetensors, or an
    orbax directory of the encoder's parameters) into `encoder` (an
    XLSREncoder: `model.ssl_model.model` of an AModel), strictly. The
    directory goes through `models.convert.xlsr_state_dict_from_flax`,
    which splits the positional conv's kernel into (||w||, w). Returns the
    dropout rates of a fairseq checkpoint's cfg, which it prints, as the
    JAX converter does."""
    from occm_tpu_torch.train.orbax import is_orbax_dir, restore_tree

    if is_orbax_dir(path):
        from occm_tpu_torch.models.convert import xlsr_state_dict_from_flax

        encoder.load_state_dict(
            xlsr_state_dict_from_flax(restore_tree(path), encoder.cfg),
            strict=True)
        return None
    if not path.endswith(CHECKPOINT_SUFFIXES):
        raise ValueError(
            f"{path!r}: neither a fairseq / HF checkpoint (.pt, .bin, "
            ".safetensors) nor an orbax directory")
    sd, wrapper = _read(path)
    encoder.load_state_dict(encoder_state_dict(sd, encoder.cfg), strict=True)
    rates = read_fairseq_dropout_rates(wrapper)
    _print_rates(rates)
    return rates


def main(argv=None) -> None:
    """`occm-convert-xlsr` of the port: ckpt -> orbax directory."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a fairseq (xlsr2_300m.pt) or HuggingFace "
        "(wav2vec2-xls-r-300m) wav2vec2 checkpoint — torch pickle or "
        ".safetensors — to an orbax directory of encoder parameters")
    ap.add_argument("pt_path")
    ap.add_argument("out_path")
    ap.add_argument("--format", choices=("auto", "fairseq", "hf"),
                    default="auto", dest="fmt")
    ap.add_argument("--tiny", action="store_true",
                    help="convert against XLSRConfig.tiny() (test ckpts)")
    args = ap.parse_args(argv)
    cfg = XLSRConfig.tiny() if args.tiny else XLSRConfig()
    convert_checkpoint_file(args.pt_path, args.out_path, cfg=cfg,
                            fmt=args.fmt)


if __name__ == "__main__":
    main()
