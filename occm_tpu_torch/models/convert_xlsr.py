"""Pretrained wav2vec2 / XLS-R checkpoints into the port's SSL frontend
(the port's own copy of what `occm_tpu.models.convert_xlsr` does for the
training CLI's --pretrained_xlsr).

Reads a fairseq checkpoint (`xlsr2_300m.pt`: {"model": state dict, "cfg":
...}) or a HuggingFace `transformers` Wav2Vec2 one (`pytorch_model.bin`, a
.pt state dict, or `model.safetensors`) and loads its encoder into an
`XLSREncoder` (`graft_pretrained_xlsr`) with `load_state_dict(strict=True)`:
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
import is needed. The tensors are all that is read.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import re
import types
from typing import Dict, Mapping

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


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The flat state dict of a fairseq / HF checkpoint: a .safetensors
    file (numpy reader), or a torch pickle (.pt / .bin) unwrapped from
    {"model": ...}, its cfg read as stubs (see the module docstring)."""
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(v)
                for k, v in load_safetensors(path).items()}
    state = torch.load(path, map_location="cpu", weights_only=False,
                       pickle_module=_STUB_PICKLE)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    if not isinstance(state, dict):
        raise ValueError(f"{path}: not a state dict or a {{'model': state "
                         f"dict}} wrapper (a {type(state).__name__})")
    return dict(state)


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


def graft_pretrained_xlsr(encoder: torch.nn.Module, path: str) -> None:
    """Load the checkpoint at `path` (.pt / .bin / .safetensors) into
    `encoder` (an XLSREncoder: `model.ssl_model.model` of an AModel),
    strictly. Any other path (an orbax directory of the JAX package)
    raises NotImplementedError naming the remedy."""
    if not path.endswith(CHECKPOINT_SUFFIXES):
        raise NotImplementedError(
            f"--pretrained_xlsr {path!r}: the port reads fairseq / HF "
            "checkpoints (.pt, .bin, .safetensors); an orbax directory of "
            "the JAX package cannot be read without orbax (ROADMAP queue A "
            "item 16). Pass the raw checkpoint, or occm-export-model's .pt "
            "through --init_from")
    sd = encoder_state_dict(read_checkpoint(path), encoder.cfg)
    encoder.load_state_dict(sd, strict=True)
