"""The port's scoring CLIs (`occm_tpu_torch.cli.oc_classifier`, `.embed`)
on the CPU against the JAX package on the same reference-named `.pt`.

Fixture as tests/test_cli_classifier.py's: 3 bonafide train rows plus one
spoof row that the scorer filters out, 4 eval utterances; the weights are a
Flax-initialised tiny AModel, every parameter and BatchNorm statistic
perturbed, written by the JAX exporter (`export_amodel_state_dict`). The
JAX side is the `OneClassScorer` its CLI wraps, on the weights its CLI
loads from the same file (`convert_model_state_dict`); the JAX CLI's own
test is in the slow lane. Tolerance: 1e-4 relative (fp32 at tiny width,
tests/test_torch_serve.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.classify import BucketedEmbedder as JBucketedEmbedder
from occm_tpu.classify import OneClassScorer as JOneClassScorer
from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.data import ASVDataset as JASVDataset
from occm_tpu.io.scorefiles import read_comma_scores
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.convert_backend import (
    convert_model_state_dict, export_amodel_state_dict, load_torch_state_dict)
from occm_tpu.serve import make_score_fn_v
from occm_tpu_torch.cli import embed, oc_classifier
from occm_tpu_torch.io.wav import write_wav

SR = 16000
RTOL = 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("classifier_cli")
    train_dir, eval_dir = root / "train", root / "eval"
    train_dir.mkdir()
    eval_dir.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        utt = f"LA_T_{i:04d}"
        t = np.arange(2400) / SR
        write_wav(str(train_dir / f"{utt}.wav"),
                  0.3 * np.sin(2 * np.pi * (250 + 30 * i) * t), SR)
        lines.append(f"LA_{i:04d} {utt} - - bonafide")
    lines.append("LA_9999 LA_T_9999 - A01 spoof")  # filtered out (spoof)
    write_wav(str(train_dir / "LA_T_9999.wav"), 0.2 * rng.normal(size=2400),
              SR)
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    eval_utts = []
    for i in range(4):
        utt = f"LA_E_{i:04d}"
        write_wav(str(eval_dir / f"{utt}.wav"),
                  0.2 * rng.normal(size=2600 + 900 * i), SR)
        eval_utts.append(utt)
    (root / "eval.txt").write_text("\n".join(eval_utts) + "\n")

    model = JAModel(JAASISTConfig(), xlsr_cfg=JXLSRConfig.tiny())
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda x: model.init(
        {"params": key, "dropout": key}, x))(jnp.zeros((2, 3200)))

    def perturb(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    ckpt = root / "aasist_vocoded_1.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                export_amodel_state_dict(variables,
                                         JXLSRConfig.tiny()).items()}, ckpt)
    return root


def _args(tree, mode, score_file, *extra):
    return ["--pretrained-sslaasist", str(tree / "aasist_vocoded_1.pt"),
            "--protocol_file", str(tree / "train.txt"),
            "--dataset_dir", str(tree / "train"),
            "--eval_protocol_file", str(tree / "eval.txt"),
            "--eval_dataset_dir", str(tree / "eval"),
            "--mode", mode, "--score_file", str(score_file),
            "--batch_size", "2", "--bucket_step", "3200", "--xlsr_tiny",
            "--device", "cpu", *extra]


def _jax_scorer(tree, cache_dir):
    """The scorer `occm_tpu.cli.oc_classifier` builds for the same flags:
    weights converted from the .pt, xla attention (auto below 5 s)."""
    restored = convert_model_state_dict(
        load_torch_state_dict(str(tree / "aasist_vocoded_1.pt")),
        xlsr_cfg=JXLSRConfig.tiny())
    variables = {"params": restored["params"],
                 "batch_stats": restored["batch_stats"]}
    model = JAModel(JAASISTConfig(), xlsr_cfg=JXLSRConfig.tiny())
    embedder = JBucketedEmbedder(
        embed_fn_factory=lambda blen: make_score_fn_v(model),
        bucket_step=3200, batch_size=2, variables=variables)
    return JOneClassScorer(embedder, cache_dir=str(cache_dir))


def test_one_class_cli_matches_jax_scorer(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the artefacts land in the working dir
    oc_classifier.main(_args(tree, "1c2", tmp_path / "scores.txt"))
    ref = np.load(tmp_path / "reference_embedding.npy")
    thr = float(np.load(tmp_path / "threshold.npy"))

    jdir = tmp_path / "jax"
    jdir.mkdir()
    scorer = _jax_scorer(tree, jdir)
    jref, jthr = scorer.create_reference_embedding(
        JASVDataset(str(tree / "train.txt"), str(tree / "train")))
    scorer.score_eval_set_1c(
        JASVDataset(str(tree / "eval.txt"), str(tree / "eval"), eval=True),
        jref, jthr, score_file=str(jdir / "scores.txt"))

    assert ref.shape == (160,) and ref.dtype == np.float32
    np.testing.assert_allclose(ref, jref, rtol=RTOL,
                               atol=RTOL * np.abs(jref).max())
    # a distance between nearly equal vectors carries the embeddings'
    # error, 1e-4 of their norm, not 1e-4 of itself (triangle inequality)
    atol = RTOL * np.linalg.norm(jref)
    assert thr == pytest.approx(jthr, rel=RTOL, abs=atol)
    assert len(np.loadtxt(tmp_path / "distances.txt")) == 3  # bonafide only
    got = read_comma_scores(str(tmp_path / "scores.txt"))
    want = read_comma_scores(str(jdir / "scores.txt"))
    assert len(got) == 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    for line, jline, d in zip(open(tmp_path / "scores.txt"),
                              open(jdir / "scores.txt"), got):
        assert line == f"{d}, {int(d > thr)} \n"
        if abs(d - thr) > atol:
            assert line.split(", ")[1] == jline.split(", ")[1]


def test_two_class_cli_matches_jax_scorer(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    oc_classifier.main(_args(tree, "2c2", tmp_path / "scores.txt"))
    assert not (tmp_path / "reference_embedding.npy").exists()
    scorer = _jax_scorer(tree, tmp_path)
    scorer.score_eval_set_2c(
        JASVDataset(str(tree / "eval.txt"), str(tree / "eval"), eval=True),
        score_file=str(tmp_path / "jax.txt"))
    got = np.loadtxt(tmp_path / "scores.txt")
    want = np.loadtxt(tmp_path / "jax.txt")
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_embed_cli_matches_jax_embed_cli(tree, tmp_path):
    from occm_tpu.cli import embed as jembed

    argv = ["--protocol_file", str(tree / "train.txt"),
            "--dataset_dir", str(tree / "train"),
            "--pretrained-sslaasist", str(tree / "aasist_vocoded_1.pt"),
            "--batch_size", "2", "--bucket_step", "3200", "--xlsr_tiny"]
    jembed.main(argv + ["--out", str(tmp_path / "jax.npz")])
    embed.main(argv + ["--out", str(tmp_path / "port.npz"),
                       "--device", "cpu"])
    want = np.load(tmp_path / "jax.npz")
    got = np.load(tmp_path / "port.npz")
    assert set(got.files) == set(want.files) == {
        "utts", "embeddings", "logits", "labels"}
    np.testing.assert_array_equal(got["utts"], want["utts"])
    np.testing.assert_array_equal(got["labels"], [0, 0, 0, 1])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    for k in ("embeddings", "logits"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=RTOL * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("extra, item", [
    (("--mode", "1c1"), "item 8"), (("--mode", "2c1"), "item 8"),
    (("--quant_int8",), "item 14"), (("--data_parallel", "2"), "item 15")])
def test_unported_modes_and_flags_raise(tree, tmp_path, extra, item):
    argv = _args(tree, "1c2", tmp_path / "s.txt") + list(extra)
    with pytest.raises(NotImplementedError, match=item):
        oc_classifier.main(argv)
    assert not (tmp_path / "s.txt").exists()
