"""The port's checkpoint converters (`occm_tpu_torch.models.convert_backend`,
`.convert_xlsr`) against the JAX package's, and the port's CLIs on orbax
directories that the JAX package wrote.

Reference-named state dicts are written by the JAX exporters from Flax
variables fabricated with seeded numpy (`tests/test_torch_models.py`) at
`XLSRConfig.tiny()` widths; fairseq and HuggingFace checkpoints are
`tests/test_torch_convert_xlsr.py`'s. The converters must give the JAX
converters' trees leaf by leaf, bit for bit (both are numpy), and their
directories must restore (through orbax) to the JAX converters'. The CLIs
(`oc_classifier` 2c2 and the 1c1 pair, `embed`, `oc_server`,
`oc_training --init_from` and `--pretrained_xlsr`) run on the CPU from a
directory written by the JAX package and must give bit for bit what the
same call gives from the `.pt` the JAX exporter makes of it.
"""

import argparse
import os
import pickle
import sys
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models import SSLResNet34 as JSSLResNet34
from occm_tpu.models import convert_backend as jconv
from occm_tpu.models import convert_xlsr as jxlsr
from occm_tpu.models.lcnn import LCNN as JLCNN
from occm_tpu.models.senet import SEResNet as JSEResNet
from occm_tpu.train import checkpoint as jckpt
from occm_tpu_torch.cli import (
    convert_model, convert_xlsr, embed, export_model, oc_classifier,
    oc_server, oc_training)
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.io.wav import write_wav
from occm_tpu_torch.models import convert_backend as conv
from occm_tpu_torch.models import convert_xlsr as cxlsr
from occm_tpu_torch.models.xlsr import XLSREncoder
from occm_tpu_torch.train import orbax
from test_torch_convert_xlsr import _tiny_fairseq_sd, _to_hf
from test_torch_models import fabricated, maps, nhwc, perturbed
from test_torch_orbax import _train_state, assert_same, orbax_restore
from test_torch_train import _cli_args, write_fixture

CUT = 3200
SR = 16000
TINY, JTINY = XLSRConfig.tiny(), JXLSRConfig.tiny()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch ops run on one thread (the suite's workers share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def flax_variables():
    """Perturbed Flax variables of each model the converters take."""
    wave = np.zeros((2, CUT), np.float32)
    x = nhwc(maps(3))
    return {
        "amodel": perturbed(fabricated(JAModel(JAASISTConfig(),
                                               xlsr_cfg=JTINY), wave)),
        "ssl_resnet34": perturbed(fabricated(JSSLResNet34(xlsr_cfg=JTINY),
                                             wave), seed=1),
        "senet": perturbed(fabricated(JSEResNet(layers=(1, 2, 3, 1)), x),
                           seed=2),
        "lcnn": perturbed(fabricated(JLCNN(asoftmax=True), x), seed=3),
        "lcnn_linear": perturbed(fabricated(JLCNN(asoftmax=False), x),
                                 seed=4),
    }


def _reference_sd(flax_variables, kind):
    """The reference-named state dict the JAX exporters write for `kind`."""
    if kind == "amodel":
        return _tensors(jconv.export_amodel_state_dict(
            flax_variables["amodel"], JTINY))
    v = flax_variables["ssl_resnet34"]
    if kind == "ssl":
        return _tensors({f"model.{k}": w for k, w in
                         jconv.export_xlsr_state_dict(
                             v["params"]["frontend"], JTINY).items()})
    if kind == "ssl_resnet34":
        sd = {f"frontend.model.{k}": w for k, w in
              jconv.export_xlsr_state_dict(v["params"]["frontend"],
                                           JTINY).items()}
        sd.update({f"resnet34.{k}": w for k, w in
                   jconv.export_senet_state_dict(
                       {"params": v["params"]["resnet34"],
                        "batch_stats": v["batch_stats"]["resnet34"]}).items()})
        return _tensors(sd)
    if kind == "senet":
        return _tensors(jconv.export_senet_state_dict(
            flax_variables["senet"], layers=(1, 2, 3, 1)))
    return _tensors(jconv.export_lcnn_state_dict(flax_variables[kind]))


KINDS = ("amodel", "ssl", "ssl_resnet34", "senet", "lcnn", "lcnn_linear")


@pytest.mark.parametrize("kind", KINDS)
def test_backend_converters_match_jax(flax_variables, tmp_path, kind):
    """convert_model_state_dict leaf by leaf, and convert_model_file's
    directory as orbax restores it, against the JAX package's."""
    sd = _reference_sd(flax_variables, kind)
    got = conv.convert_model_state_dict(sd, xlsr_cfg=TINY)
    want = jconv.convert_model_state_dict(sd, xlsr_cfg=JTINY)
    assert got.pop("_kind") == want.pop("_kind") == kind.split("_l")[0]
    assert_same(jax.tree_util.tree_map(np.asarray, want), got)
    torch.save(sd, tmp_path / "model.pt")
    assert conv.convert_model_file(str(tmp_path / "model.pt"),
                                   str(tmp_path / "port"), xlsr_cfg=TINY) \
        == jconv.convert_model_file(str(tmp_path / "model.pt"),
                                    str(tmp_path / "jax"), xlsr_cfg=JTINY)
    assert_same(orbax_restore(tmp_path / "jax"),
                orbax_restore(tmp_path / "port"))


@pytest.mark.parametrize("kind", ("amodel", "ssl_resnet34", "senet",
                                  "lcnn"))
def test_export_matches_the_jax_export(flax_variables, tmp_path, kind):
    """The port's export_model_file of a port-written directory (and of the
    JAX converter's) equals the JAX package's export_model_file of it, key
    by key and bit for bit; the JAX exporter writes num_batches_tracked
    with shape [1] (np.ascontiguousarray), the port with torch's shape []."""
    sd = _reference_sd(flax_variables, kind)
    torch.save(sd, tmp_path / "model.pt")
    conv.convert_model_file(str(tmp_path / "model.pt"), str(tmp_path / "p"),
                            xlsr_cfg=TINY)
    jconv.convert_model_file(str(tmp_path / "model.pt"), str(tmp_path / "j"),
                             xlsr_cfg=JTINY)
    jconv.export_model_file(str(tmp_path / "p"), str(tmp_path / "jax.pt"),
                            xlsr_cfg=JTINY)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    for src in ("p", "j"):
        out = tmp_path / f"port_{src}.pt"
        conv.export_model_file(str(tmp_path / src), str(out), xlsr_cfg=TINY)
        got = torch.load(out, weights_only=True)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            if k.endswith("num_batches_tracked"):
                assert g.shape == () and w.shape == (1,)
                g = g.reshape(1)
            assert g.dtype == w.dtype and torch.equal(g, w), k


@pytest.mark.parametrize("prefix, hf", [("", None), ("w2v_model.", None),
                                        ("", 0), ("", 1)],
                         ids=["fairseq", "w2v_model", "hf_weight_g_v",
                              "hf_parametrizations"])
def test_xlsr_converters_match_jax(tmp_path, prefix, hf):
    sd = _tiny_fairseq_sd(seed=6)
    if hf is None:
        sd = {prefix + k: v for k, v in sd.items()}
        got = cxlsr.convert_fairseq_state_dict(sd, TINY)
        want = jxlsr.convert_fairseq_state_dict(sd, JTINY)
    else:
        sd = _to_hf(sd, hf)
        got = cxlsr.convert_hf_state_dict(sd, TINY)
        want = jxlsr.convert_hf_state_dict(sd, JTINY)
    assert_same(want, got)
    torch.save({"model": sd} if hf is None else sd, tmp_path / "x.pt")
    fmt = "hf" if hf is not None else "fairseq"
    convert_xlsr.main([str(tmp_path / "x.pt"), str(tmp_path / "port"),
                       "--tiny", "--format", fmt])
    jxlsr.convert_checkpoint_file(str(tmp_path / "x.pt"),
                                  str(tmp_path / "jax"), cfg=JTINY, fmt=fmt)
    assert_same(orbax_restore(tmp_path / "jax"),
                orbax_restore(tmp_path / "port"))


class _FakeDictConfig:
    """An omegaconf DictConfig as it pickles: its state holds `_content`,
    whose values are nodes holding `_val`."""

    def __init__(self, content):
        self._content = content
        self._metadata = {"flags": None}

    def __getstate__(self):
        return dict(vars(self))


class _FakeAnyNode:
    def __init__(self, val):
        self._val = val
        self._metadata = {"optional": True}

    def __getstate__(self):
        return dict(vars(self))


def test_dropout_rates_match_jax_and_read_through_stubs(tmp_path, capsys):
    """read_fairseq_dropout_rates against JAX's on a modern-cfg and a
    legacy-args wrapper, and from the stubs of a .pt whose cfg classes
    (an omegaconf-like DictConfig, an argparse.Namespace) the reader does
    not import; the graft and the converter print them."""
    model = {"dropout": 0.1, "attention_dropout": 0.05,
             "activation_dropout": 0.0, "dropout_input": 0.1,
             "encoder_layerdrop": 0.05}
    modern = {"cfg": {"model": dict(model)}, "model": {}}
    legacy = {"args": argparse.Namespace(
        dropout=0.2, attention_dropout=0.1, activation_dropout=0.05,
        dropout_input=0.0, encoder_layerdrop=0.0), "model": {}}
    for wrapper in (modern, legacy, {"model": {}}):
        assert cxlsr.read_fairseq_dropout_rates(wrapper) == \
            jxlsr.read_fairseq_dropout_rates(wrapper)

    mod = types.ModuleType("omegaconf_gone")
    for cls in (_FakeDictConfig, _FakeAnyNode):
        cls.__module__ = mod.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules[mod.__name__] = mod
    sd = _tiny_fairseq_sd(seed=7)
    try:
        cfg = _FakeDictConfig({"model": _FakeDictConfig(
            {k: _FakeAnyNode(v) for k, v in model.items()})})
        torch.save({"model": sd, "cfg": cfg}, tmp_path / "modern.pt",
                   pickle_protocol=pickle.HIGHEST_PROTOCOL)
        torch.save({"model": sd, "args": legacy["args"]},
                   tmp_path / "legacy.pt")
    finally:
        del sys.modules[mod.__name__]
        for cls in (_FakeDictConfig, _FakeAnyNode):
            cls.__module__ = __name__
    want_modern = jxlsr.read_fairseq_dropout_rates(modern)
    for name, want in (("modern", want_modern),
                       ("legacy", jxlsr.read_fairseq_dropout_rates(legacy))):
        encoder = XLSREncoder(TINY)
        assert cxlsr.graft_pretrained_xlsr(
            encoder, str(tmp_path / f"{name}.pt")) == want
        assert "checkpoint cfg dropout rates" in capsys.readouterr().out
    rates = cxlsr.convert_checkpoint_file(str(tmp_path / "modern.pt"),
                                          str(tmp_path / "dir"), cfg=TINY)
    assert rates == want_modern and "dropout=0.1" in capsys.readouterr().out


# ------------------------------------------------- the CLIs on a directory

@pytest.fixture(scope="module")
def scoring_tree(tmp_path_factory, flax_variables):
    """Train and eval utterances; the AModel as a JAX trainer epoch
    directory and its JAX export; SSLResNet34's frontend and SE-ResNet as
    JAX-saved {"params", "batch_stats"} directories and the .pt files the
    JAX exporters make of them."""
    root = tmp_path_factory.mktemp("orbax_cli")
    (root / "train").mkdir()
    (root / "eval").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        utt = f"LA_T_{i:04d}"
        t = np.arange(2400) / SR
        write_wav(str(root / "train" / f"{utt}.wav"),
                  0.3 * np.sin(2 * np.pi * (250 + 30 * i) * t), SR)
        lines.append(f"LA_{i:04d} {utt} - - bonafide")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    utts = [f"LA_E_{i:04d}" for i in range(3)]
    for i, utt in enumerate(utts):
        write_wav(str(root / "eval" / f"{utt}.wav"),
                  0.2 * rng.normal(size=2600 + 900 * i), SR)
    (root / "eval.txt").write_text("\n".join(utts) + "\n")

    state = _train_state(flax_variables["amodel"])
    epoch = jckpt.save_checkpoint(state, str(root), "aasist_vocoded", 1)
    jconv.export_model_file(epoch, str(root / "aasist.pt"), xlsr_cfg=JTINY)
    v = flax_variables["ssl_resnet34"]
    jckpt.save_params({"params": v["params"]["frontend"], "batch_stats": {}},
                      str(root / "ssl_dir"))
    senet = {"params": v["params"]["resnet34"],
             "batch_stats": v["batch_stats"]["resnet34"]}
    jckpt.save_params(senet, str(root / "senet_dir"))
    torch.save(_tensors({f"model.{k}": w for k, w in
                         jconv.export_xlsr_state_dict(
                             v["params"]["frontend"], JTINY).items()}),
               root / "ssl.pt")
    torch.save(_tensors(jconv.export_senet_state_dict(senet)),
               root / "senet.pt")
    return root, epoch


def _score_args(root, mode, score_file, *weights):
    return ["--protocol_file", str(root / "train.txt"),
            "--dataset_dir", str(root / "train"),
            "--eval_protocol_file", str(root / "eval.txt"),
            "--eval_dataset_dir", str(root / "eval"),
            "--mode", mode, "--score_file", str(score_file),
            "--batch_size", "2", "--bucket_step", "3200", "--xlsr_tiny",
            "--device", "cpu", *weights]


@pytest.mark.parametrize("mode", ["2c2", "1c1"])
def test_classifier_scores_a_jax_directory_as_its_export(
        scoring_tree, tmp_path, monkeypatch, mode):
    root, epoch = scoring_tree
    if mode == "2c2":
        weights = {"dir": ["--pretrained-sslaasist", epoch],
                   "pt": ["--pretrained-sslaasist", str(root / "aasist.pt")]}
    else:
        weights = {"dir": ["--pretrained-ssl", str(root / "ssl_dir"),
                           "--pretrained-senet", str(root / "senet_dir")],
                   "pt": ["--pretrained-ssl", str(root / "ssl.pt"),
                          "--pretrained-senet", str(root / "senet.pt")]}
    out = {}
    for how, flags in weights.items():
        run = tmp_path / how
        run.mkdir()
        monkeypatch.chdir(run)
        oc_classifier.main(_score_args(root, mode, run / "s.txt", *flags))
        out[how] = (run / "s.txt").read_text()
        if mode == "1c1":
            out[how + "_ref"] = np.load(run / "reference_embedding.npy")
    assert len(out["dir"].splitlines()) == 3 and out["dir"] == out["pt"]
    if mode == "1c1":
        assert np.array_equal(out["dir_ref"], out["pt_ref"])


def test_embed_and_server_read_a_jax_directory_as_its_export(
        scoring_tree, tmp_path):
    root, epoch = scoring_tree
    argv = ["--protocol_file", str(root / "train.txt"),
            "--dataset_dir", str(root / "train"), "--batch_size", "2",
            "--bucket_step", "3200", "--xlsr_tiny", "--device", "cpu"]
    for how, path in (("dir", epoch), ("pt", str(root / "aasist.pt"))):
        embed.main(argv + ["--pretrained-sslaasist", path,
                           "--out", str(tmp_path / f"{how}.npz")])
    a, b = np.load(tmp_path / "dir.npz"), np.load(tmp_path / "pt.npz")
    for k in ("embeddings", "logits"):
        assert np.array_equal(a[k], b[k]), k

    np.save(tmp_path / "reference_embedding.npy", a["embeddings"][0])
    np.save(tmp_path / "threshold.npy", np.float32(1.0))
    wave = (0.2 * np.random.default_rng(1).normal(size=3000)).astype("<f4")
    scores = {}
    for how, path in (("dir", epoch), ("pt", str(root / "aasist.pt"))):
        started = threading.Event()
        started.stop = threading.Event()
        t = threading.Thread(target=oc_server.main, args=([
            "--pretrained-sslaasist", path, "--artifacts_dir",
            str(tmp_path), "--host", "127.0.0.1", "--port", "0",
            "--xlsr_tiny", "--batch_size", "2", "--buckets", str(CUT),
            "--device", "cpu", "--no_warmup"], started), daemon=True)
        t.start()
        assert started.wait(timeout=120), "server failed to start"
        try:
            scores[how] = started.service.score([wave])[0]
        finally:
            started.stop.set()
            t.join(timeout=30)
        assert not t.is_alive()
    assert np.array_equal(scores["dir"], scores["pt"])


def _train(files, ckpt_dir, *extra):
    losses = []
    state = oc_training.main(_cli_args(*files, str(ckpt_dir), *extra),
                             on_step=lambda s, m: losses.append(
                                 float(m["loss"])))
    return losses, {k: v.clone() for k, v in state.model.state_dict().items()}


def test_training_starts_from_jax_directories_as_from_their_exports(
        scoring_tree, tmp_path, monkeypatch, flax_variables):
    """--init_from a JAX trainer epoch directory (and a bare parameter
    tree, which keeps the model's BatchNorm statistics), and
    --pretrained_xlsr an occm-convert-xlsr directory, train an epoch bit
    for bit as from the .pt the JAX exporters make of them."""
    root, epoch = scoring_tree
    files = write_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    from_dir = _train(files, tmp_path / "a", "--init_from", epoch)
    from_pt = _train(files, tmp_path / "b", "--init_from",
                     str(root / "aasist.pt"))
    assert len(from_dir[0]) == 6 and from_dir[0] == from_pt[0]
    for k, v in from_pt[1].items():
        assert torch.equal(from_dir[1][k], v), k

    bare = tmp_path / "bare"
    jckpt.save_params(flax_variables["amodel"]["params"], str(bare))
    model = oc_training.build_model(TINY, 0, init_from=str(bare))
    seeded = oc_training.build_model(TINY, 0)
    exported = torch.load(root / "aasist.pt", weights_only=True)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(v, seeded.state_dict()[k]), k
        elif k in exported and "pos_conv" not in k:
            assert torch.equal(v, exported[k]), k

    torch.save({"model": _tiny_fairseq_sd(seed=8)}, tmp_path / "fs.pt")
    jxlsr.convert_checkpoint_file(str(tmp_path / "fs.pt"),
                                  str(tmp_path / "xlsr_dir"), cfg=JTINY)
    params = ocp.StandardCheckpointer().restore(str(tmp_path / "xlsr_dir"))
    torch.save({"model": _tensors(jconv.export_xlsr_state_dict(
        params, JTINY))}, tmp_path / "xlsr_export.pt")
    from_dir = _train(files, tmp_path / "c", "--pretrained_xlsr",
                      str(tmp_path / "xlsr_dir"))
    from_pt = _train(files, tmp_path / "d", "--pretrained_xlsr",
                     str(tmp_path / "xlsr_export.pt"))
    assert from_dir[0] == from_pt[0]
    for k, v in from_pt[1].items():
        assert torch.equal(from_dir[1][k], v), k


def test_converter_clis_take_the_jax_flags(flax_variables, tmp_path,
                                           capsys):
    """convert_model / export_model with --kind and --tiny: a reference .pt
    to a directory and back to the same state dict (the positional conv
    through its fold and split, at the fold's rounding)."""
    sd = _reference_sd(flax_variables, "amodel")
    torch.save(sd, tmp_path / "a.pt")
    convert_model.main([str(tmp_path / "a.pt"), str(tmp_path / "dir"),
                        "--kind", "amodel", "--tiny"])
    assert "(amodel)" in capsys.readouterr().out
    export_model.main([str(tmp_path / "dir"), str(tmp_path / "back.pt"),
                       "--kind", "amodel", "--tiny"])
    back = torch.load(tmp_path / "back.pt", weights_only=True)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if "pos_conv.0.weight_" in k:
            torch.testing.assert_close(back[k], v, rtol=2e-6, atol=0)
        else:
            assert torch.equal(back[k], v.reshape(back[k].shape)), k
    with pytest.raises(ValueError, match="holds a amodel model, not senet"):
        export_model.main([str(tmp_path / "dir"), str(tmp_path / "x.pt"),
                           "--kind", "senet", "--tiny"])
    assert not os.path.exists(tmp_path / "x.pt")
