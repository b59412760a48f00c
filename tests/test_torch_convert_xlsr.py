"""The port's --pretrained_xlsr reader (`occm_tpu_torch.models.convert_xlsr`)
against the JAX package's converter (`occm_tpu.models.convert_xlsr`).

Tiny checkpoints are built here in fairseq's naming (with the tensors only
pretraining uses) and in HuggingFace's, written as a fairseq-style .pt, a
.safetensors file and an HF .bin. The port grafts each into its
XLSREncoder; the JAX package converts the same state dict into the Flax
XLSREncoder. Both encode the same seeded waves; tolerance atol 3e-5 / rtol
1e-4, that of tests/test_torch_xlsr.py. Every grafted tensor equals the
file's bit for bit, except the positional conv, whose weight-norm pair
(g, v) is folded into one kernel: v * (g / ||v||) in the port, g * v /
||v|| in the JAX converter, so the two round apart by a few ulps (held at
rtol 2e-6).
"""

import json
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models.convert_xlsr import (
    convert_fairseq_state_dict, convert_hf_state_dict)
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models.convert_xlsr import (
    detect_format, graft_pretrained_xlsr, hf_to_fairseq_names,
    load_safetensors, read_checkpoint)
from occm_tpu_torch.models.xlsr import XLSREncoder

CFG = XLSRConfig.tiny()
JCFG = JXLSRConfig.tiny()
C = CFG.conv_layers[-1][0]
D = CFG.encoder_embed_dim
CUT = 3200
ATOL, RTOL = 3e-5, 1e-4
POS = "encoder.pos_conv.0."
PRETRAINING = ("mask_emb", "quantizer.vars", "quantizer.weight_proj.weight",
               "project_q.weight", "final_proj.weight")


def _tiny_fairseq_sd(seed=0, conv_bias=True):
    """A tiny wav2vec2 state dict in fairseq's naming, every tensor random,
    plus the tensors only pretraining uses."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.2, base=0.0):
        return base + torch.randn(*shape, generator=g) * scale

    sd = {}
    in_ch = 1
    for i, (dim, k, _) in enumerate(CFG.conv_layers):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = r(dim, in_ch, k)
        if conv_bias:
            sd[f"feature_extractor.conv_layers.{i}.0.bias"] = r(dim)
        sd[f"feature_extractor.conv_layers.{i}.2.1.weight"] = r(
            dim, scale=0.05, base=1.0)
        sd[f"feature_extractor.conv_layers.{i}.2.1.bias"] = r(dim, scale=0.05)
        in_ch = dim
    sd["layer_norm.weight"] = r(C, scale=0.05, base=1.0)
    sd["layer_norm.bias"] = r(C, scale=0.05)
    if C != D:
        sd["post_extract_proj.weight"] = r(D, C)
        sd["post_extract_proj.bias"] = r(D)
    sd[POS + "weight_g"] = r(1, 1, CFG.conv_pos, scale=0.05, base=1.0)
    sd[POS + "weight_v"] = r(D, D // CFG.conv_pos_groups, CFG.conv_pos)
    sd[POS + "bias"] = r(D)
    for layer in range(CFG.encoder_layers):
        pre = f"encoder.layers.{layer}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{name}.weight"] = r(D, D)
            sd[f"{pre}.self_attn.{name}.bias"] = r(D)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{pre}.{ln}.weight"] = r(D, scale=0.05, base=1.0)
            sd[f"{pre}.{ln}.bias"] = r(D, scale=0.05)
        sd[f"{pre}.fc1.weight"] = r(CFG.encoder_ffn_dim, D)
        sd[f"{pre}.fc1.bias"] = r(CFG.encoder_ffn_dim)
        sd[f"{pre}.fc2.weight"] = r(D, CFG.encoder_ffn_dim)
        sd[f"{pre}.fc2.bias"] = r(D)
    sd["encoder.layer_norm.weight"] = r(D, scale=0.05, base=1.0)
    sd["encoder.layer_norm.bias"] = r(D, scale=0.05)
    sd["mask_emb"] = r(D)
    sd["quantizer.vars"] = r(1, 16, 8)
    sd["quantizer.weight_proj.weight"] = r(16, C)
    sd["project_q.weight"] = r(8, 8)
    sd["final_proj.weight"] = r(8, D)
    return sd


_TO_HF = (  # fairseq -> HuggingFace transformers naming, written out here
    (r"^feature_extractor\.conv_layers\.(\d+)\.0\.",
     r"feature_extractor.conv_layers.\1.conv."),
    (r"^feature_extractor\.conv_layers\.(\d+)\.2\.1\.",
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (r"^layer_norm\.", "feature_projection.layer_norm."),
    (r"^post_extract_proj\.", "feature_projection.projection."),
    (r"^encoder\.pos_conv\.0\.bias", "encoder.pos_conv_embed.conv.bias"),
    (r"\.self_attn\.", ".attention."),
    (r"\.self_attn_layer_norm\.", ".layer_norm."),
    (r"\.fc1\.", ".feed_forward.intermediate_dense."),
    (r"\.fc2\.", ".feed_forward.output_dense."),
)


def _to_hf(sd, spelling):
    """The fairseq dict in HF naming (`wav2vec2.` prefixed, HF's own
    pretraining tensors added), its weight norm spelled `weight_g/v` or
    `parametrizations.weight.original0/1`."""
    wn = {"weight_g": ("weight_g", "parametrizations.weight.original0"),
          "weight_v": ("weight_v", "parametrizations.weight.original1")}
    out = {}
    for k, v in sd.items():
        if k in PRETRAINING:
            continue
        if k.startswith(POS + "weight_"):
            part = k[len(POS):]
            k = "encoder.pos_conv_embed.conv." + wn[part][spelling]
        for old, new in _TO_HF:
            k = re.sub(old, new, k)
        out["wav2vec2." + k] = v
    gen = torch.Generator().manual_seed(9)
    for k, shape in (("wav2vec2.masked_spec_embed", (D,)),
                     ("quantizer.codevectors", (1, 16, 8)),
                     ("quantizer.weight_proj.weight", (16, C)),
                     ("project_hid.weight", (8, D)),
                     ("project_q.weight", (8, 8))):
        out[k] = torch.randn(*shape, generator=gen)
    return out


_ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
              np.dtype(np.int64): "I64", np.dtype(np.int32): "I32",
              np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL"}


def _write_safetensors(path, arrays, dtypes=None):
    """The safetensors layout, written with numpy: an 8-byte header length,
    the JSON header (padded to 8 bytes), then the raw tensor bytes."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, a in arrays.items():
        raw = np.ascontiguousarray(a).tobytes()
        header[name] = {"dtype": (dtypes or {}).get(name)
                        or _ST_DTYPES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _jax_features(params, x):
    return np.asarray(JXLSREncoder(JCFG).apply({"params": params},
                                               jnp.asarray(x)))


def _port_features(encoder, x):
    with torch.no_grad():
        return encoder.eval()(torch.from_numpy(x)).numpy()


def _wave(seed=7):
    return (np.random.default_rng(seed).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)


def _assert_grafted(encoder, sd, jparams):
    """Every grafted tensor equals the fairseq dict's bit for bit; the
    folded positional conv kernel is held to the JAX converter's fold."""
    got = encoder.state_dict()
    for k, v in sd.items():
        if k in PRETRAINING or k.startswith(POS + "weight_"):
            continue
        assert torch.equal(got[k], v), k
    w = encoder.encoder.pos_conv[0].weight.detach().numpy()
    want = np.asarray(jparams["pos_conv"]["kernel"]).transpose(2, 1, 0)
    np.testing.assert_allclose(w, want, rtol=2e-6, atol=0)


class _Unimportable:
    """A checkpoint cfg whose class's module is gone when it is read."""

    def __init__(self, model):
        self.model = model


def _unimportable_cfg():
    mod = types.ModuleType("fairseq_cfg_gone")
    cls = type("DictConfig", (_Unimportable,), {})
    cls.__module__ = mod.__name__
    mod.DictConfig = cls
    sys.modules[mod.__name__] = mod
    return cls({"dropout": 0.1, "encoder_layerdrop": 0.05})


@pytest.mark.parametrize("prefix", ["", "w2v_model.",
                                    "w2v_encoder.w2v_model."],
                         ids=["bare", "w2v_model", "fine_tuned"])
def test_fairseq_checkpoint_grafts_and_matches_flax(tmp_path, prefix):
    sd = _tiny_fairseq_sd()
    wrapped = {prefix + k: v for k, v in sd.items()}
    if prefix.startswith("w2v_encoder"):  # a fine-tuned model's CTC head
        wrapped["w2v_encoder.proj.weight"] = torch.randn(32, D)
        wrapped["w2v_encoder.proj.bias"] = torch.randn(32)
    path = tmp_path / "xlsr.pt"
    try:
        torch.save({"model": wrapped, "cfg": _unimportable_cfg()}, path)
    finally:
        del sys.modules["fairseq_cfg_gone"]
    encoder = XLSREncoder(CFG)
    graft_pretrained_xlsr(encoder, str(path))
    jparams = convert_fairseq_state_dict(wrapped, JCFG)
    _assert_grafted(encoder, sd, jparams)
    x = _wave()
    np.testing.assert_allclose(_port_features(encoder, x),
                               _jax_features(jparams, x), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("spelling", [0, 1],
                         ids=["weight_g_v", "parametrizations"])
def test_hf_safetensors_grafts_and_matches_flax(tmp_path, spelling):
    sd = _tiny_fairseq_sd(seed=1)
    hf = _to_hf(sd, spelling)
    assert detect_format(hf) == "hf" and detect_format(sd) == "fairseq"
    renamed = hf_to_fairseq_names(hf, CFG)
    assert set(renamed) == set(sd) - set(PRETRAINING)
    arrays = {k: v.numpy() for k, v in hf.items()}
    path = tmp_path / "model.safetensors"
    _write_safetensors(path, arrays)
    back = load_safetensors(str(path))
    assert back.keys() == arrays.keys()
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and np.array_equal(back[k], a), k
    encoder = XLSREncoder(CFG)
    graft_pretrained_xlsr(encoder, str(path))
    jparams = convert_hf_state_dict(arrays, JCFG)
    _assert_grafted(encoder, sd, jparams)
    x = _wave(8)
    np.testing.assert_allclose(_port_features(encoder, x),
                               _jax_features(jparams, x), atol=ATOL,
                               rtol=RTOL)
    # the same dict as an HF torch pickle (.bin) grafts the same weights
    bin_path = tmp_path / "pytorch_model.bin"
    torch.save(hf, bin_path)
    again = XLSREncoder(CFG)
    graft_pretrained_xlsr(again, str(bin_path))
    for k, v in encoder.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_safetensors_reader_is_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "i64": rng.integers(-9, 9, (2, 2, 2)).astype(np.int64),
              "i32": np.array(5, np.int32),
              "u8": rng.integers(0, 255, (9,)).astype(np.uint8),
              "bool": rng.integers(0, 2, (4,)).astype(np.bool_)}
    # bf16 has no numpy dtype: written as the top halves of fp32 patterns
    f32 = rng.normal(size=(6,)).astype(np.float32)
    arrays["bf16"] = (f32.view(np.uint32) >> 16).astype(np.uint16)
    path = tmp_path / "t.safetensors"
    _write_safetensors(path, arrays, {"bf16": "BF16"})
    back = load_safetensors(str(path))
    for k, a in arrays.items():
        if k == "bf16":
            want = (f32.view(np.uint32) & 0xFFFF0000).view(np.float32)
            assert back[k].dtype == np.float32
            assert np.array_equal(back[k], want)
        else:
            assert back[k].dtype == a.dtype and back[k].shape == a.shape
            assert np.array_equal(back[k], a), k
    tensors = read_checkpoint(str(path))
    assert torch.equal(tensors["f32"], torch.from_numpy(arrays["f32"]))


_CALLS = []


def _record_call(*args):
    _CALLS.append(args)


class _Reduces:
    """Unpickles by calling _record_call: a stand-in for a global a
    checkpoint may name and the reader must not run."""

    def __reduce__(self):
        return (_record_call, ("ran",))


def test_pt_with_unimportable_cfg_loads_and_runs_none_of_its_code(tmp_path):
    import argparse

    sd = {"feature_extractor.conv_layers.0.0.weight": torch.randn(4, 1, 3)}
    path = tmp_path / "legacy.pt"
    try:
        torch.save({"model": sd, "cfg": _unimportable_cfg(),
                    "args": argparse.Namespace(dropout=0.1),
                    "extra": _Reduces()}, path)
    finally:
        del sys.modules["fairseq_cfg_gone"]
    with pytest.raises(ModuleNotFoundError):  # what pickle alone meets
        torch.load(path, weights_only=False)
    got = read_checkpoint(str(path))
    assert got.keys() == sd.keys()
    assert torch.equal(got["feature_extractor.conv_layers.0.0.weight"],
                       sd["feature_extractor.conv_layers.0.0.weight"])
    assert _CALLS == []


def test_bias_free_conv_layers_get_zero_biases(tmp_path):
    sd = _tiny_fairseq_sd(seed=2, conv_bias=False)
    path = tmp_path / "nobias.pt"
    torch.save({"model": sd}, path)
    encoder = XLSREncoder(CFG)
    graft_pretrained_xlsr(encoder, str(path))
    for i in range(len(CFG.conv_layers)):
        b = encoder.feature_extractor.conv_layers[i]["0"].bias
        assert not b.any()
    jparams = convert_fairseq_state_dict(sd, JCFG)
    x = _wave(9)
    np.testing.assert_allclose(_port_features(encoder, x),
                               _jax_features(jparams, x), atol=ATOL,
                               rtol=RTOL)


def test_orbax_directory_raises_naming_the_remedy(tmp_path):
    """An orbax directory of the JAX converter grafts (`train.orbax`, no
    orbax): every tensor equals the .pt graft's, the positional conv
    within the fold's rounding; the trainer's --pretrained_xlsr takes it.
    A directory that holds no orbax checkpoint raises, naming what the
    flag takes."""
    from occm_tpu.models.convert_xlsr import convert_checkpoint_file

    sd = _tiny_fairseq_sd(seed=4)
    pt = tmp_path / "xlsr.pt"
    torch.save({"model": sd}, pt)
    convert_checkpoint_file(str(pt), str(tmp_path / "xlsr_orbax"), cfg=JCFG)
    from_pt, from_dir = XLSREncoder(CFG), XLSREncoder(CFG)
    graft_pretrained_xlsr(from_pt, str(pt))
    assert graft_pretrained_xlsr(from_dir, str(tmp_path / "xlsr_orbax")) \
        is None
    want = from_pt.state_dict()
    for k, v in from_dir.state_dict().items():
        if POS + "weight_" in k:
            torch.testing.assert_close(v, want[k], rtol=2e-6, atol=0)
        else:
            assert torch.equal(v, want[k]), k
    from occm_tpu_torch.cli import oc_training

    model = oc_training.build_model(CFG, 0, pretrained_xlsr=str(
        tmp_path / "xlsr_orbax"))
    for k, v in from_dir.state_dict().items():
        assert torch.equal(model.ssl_model.model.state_dict()[k], v), k
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="nor an orbax directory"):
        graft_pretrained_xlsr(XLSREncoder(CFG), str(tmp_path / "empty"))
