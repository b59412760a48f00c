"""The port's parity gate (`occm_tpu_torch.cli.parity_gate`) and its torch
oracle (`occm_tpu_torch.models.torch_oracle`) on the CPU.

- The port's oracle against the JAX package's (`occm_tpu.models.
  torch_oracle`), both on torch, bit for bit: on a positional conv whose
  weight-norm fold is exact in both packages' arithmetic (every |v| is
  1/8, so ||v|| over a kernel tap is a power of two and g * v / ||v|| and
  v * (g / ||v||) round alike), for XLS-R's pre-norm layout, a post-norm
  one and wav2vec2-base's group-norm extractor; on a general weight-norm
  pair the two folds may round one fp32 ulp apart, so there within 1e-5
  of the largest |value|.
- The gate end to end on the JAX gate's synthetic stand-ins
  (tests/test_parity_gate.py: a tiny fairseq-format .pt and a fixture
  tree in the standard LA layout): every stage prints PASS, the exit code
  is 0 and the dev EER of the separable task is under 0.3; a failing
  --ref_eer gate exits 1, as does a checkpoint that cannot be read.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models.torch_oracle import \
    torch_wav2vec2_oracle as jax_oracle
from occm_tpu_torch.cli import parity_gate
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models import XLSREncoder
from occm_tpu_torch.models.torch_oracle import torch_wav2vec2_oracle
from occm_tpu_torch.utils import random_init_
from test_parity_gate import CUT, fake_xlsr_pt, la_tree  # noqa: F401

#: the JAX gate's test trains 6 epochs; 2 keep this file near half a
#: minute on one CPU thread (the tiny XLSR under the full AASIST backend,
#: ~13 s an epoch), and the separable task's dev EER is 0 after either
EPOCHS = 2
ORACLE_CFGS = {
    "xlsr_tiny": {},
    "post_norm": dict(layer_norm_first=False),
    "base_layout": dict(extractor_mode="default", layer_norm_first=False),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch ops run on one thread (tiny models; the suite's
    workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fairseq_sd(fields, exact_fold, seed=0):
    """A random fairseq-named encoder state dict of the tiny config with
    `fields` (the port's XLSREncoder's, written with weight_g / weight_v)."""
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    sd = random_init_(XLSREncoder(cfg), seed=seed).state_dict()
    if exact_fold:
        gen = torch.Generator().manual_seed(seed + 1)
        v = sd["encoder.pos_conv.0.weight_v"]
        sign = torch.randint(0, 2, v.shape, generator=gen) * 2 - 1
        sd["encoder.pos_conv.0.weight_v"] = sign.float() / 8.0
        sd["encoder.pos_conv.0.weight_g"] = 0.5 + torch.rand(
            sd["encoder.pos_conv.0.weight_g"].shape, generator=gen)
    return cfg, sd


@pytest.mark.parametrize("exact_fold", [True, False])
@pytest.mark.parametrize("name", sorted(ORACLE_CFGS))
def test_oracle_matches_jax_packages_oracle(name, exact_fold):
    cfg, sd = _fairseq_sd(ORACLE_CFGS[name], exact_fold)
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **ORACLE_CFGS[name])
    wave = (np.random.default_rng(3).normal(size=(2, 4000)) * 0.1).astype(
        np.float32)
    got = torch_wav2vec2_oracle(sd, wave, cfg)
    want = jax_oracle(sd, wave, jcfg)
    assert got.shape == want.shape == (2, 199, cfg.encoder_embed_dim)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if exact_fold:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_oracle_agrees_with_the_ports_encoder():
    """The oracle and the port's fp32 XLSREncoder on the same state dict,
    as the gate's verify stage holds them (its default tolerance 1e-3)."""
    cfg, sd = _fairseq_sd({}, exact_fold=False, seed=4)
    model = XLSREncoder(cfg).eval()
    model.load_state_dict(sd, strict=True)
    wave = (np.random.default_rng(5).normal(size=(1, 16000)) * 0.1).astype(
        np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(wave)).numpy()
    diff = np.abs(ours - torch_wav2vec2_oracle(sd, wave, cfg)).max()
    assert diff <= 1e-4, diff


def _gate_argv(root, vocoded_dir, xlsr, workdir, *extra):
    return ["--xlsr", xlsr, "--la", str(root), "--workdir", str(workdir),
            "--xlsr_tiny", "--epochs", str(EPOCHS), "--cut", str(CUT),
            "--batch_size", "4", "--bucket_step", str(CUT), "--device",
            "cpu", *(["--vocoded_dir", vocoded_dir] if vocoded_dir else []),
            *extra]


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def gate_run(la_tree, fake_xlsr_pt, tmp_path_factory):  # noqa: F811
    """One end-to-end run, with the JAX gate test's training flags but
    EPOCHS epochs: (exit code, stdout, workdir)."""
    import contextlib
    import io

    root, vocoded_dir = la_tree
    workdir = tmp_path_factory.mktemp("gate")
    cwd = os.getcwd()
    os.chdir(workdir)  # oc_classifier's 1c artefacts land here
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = parity_gate.main(_gate_argv(
                root, vocoded_dir, fake_xlsr_pt, workdir / "gate",
                "--lr", "1e-3", "--groups_per_step", "4",
                "--compactness_weight", "0.1",
                "--descriptiveness_weight", "0.9",
                # tiny model, few epochs: fp and int8 EER both land near 0
                # on the separable task; the stage proves the plumbing,
                # the tight default (0.002) is for real 300M weights
                "--int8_gate", "0.25"))
    finally:
        os.chdir(cwd)
    return rc, out.getvalue(), workdir / "gate"


def test_gate_end_to_end_passes_every_stage(gate_run):
    rc, out, workdir = gate_run
    summary = _summary(out)
    assert rc == 0, out
    assert summary["ok"] is True
    for name in ("convert", "verify", "train", "eer", "int8"):
        assert summary["stages"][name]["ok"], summary
        assert f"GATE {name} PASS" in out
    assert summary["eer_value"] < 0.3, summary
    assert 0.0 <= summary["eer_int8_value"] <= 1.0
    assert "fairseq checkpoint" in summary["stages"]["convert"]["detail"]
    assert os.path.isfile(workdir / "xlsr_params" / "_METADATA")
    for name in (f"aasist_vocoded_{EPOCHS - 1}.pt", "scores_fp32.txt",
                 "scores_int8.txt", "dev_utts.txt"):
        assert os.path.isfile(workdir / name), name


def test_gate_hands_the_trainer_a_strict_encoder_checkpoint(
        gate_run, fake_xlsr_pt):  # noqa: F811
    """xlsr_params is the orbax directory the JAX gate hands its trainer:
    the JAX converter's parameter tree of the fairseq checkpoint, leaf for
    leaf and bit for bit (orbax restores it), strictly loadable by
    --pretrained_xlsr's graft."""
    import jax
    import orbax.checkpoint as ocp

    from occm_tpu.models.convert_xlsr import (
        convert_fairseq_state_dict, load_checkpoint_state_dict)
    from occm_tpu_torch.models.convert_xlsr import graft_pretrained_xlsr

    _, _, workdir = gate_run
    path = str(workdir / "xlsr_params")
    saved = ocp.StandardCheckpointer().restore(path)
    want = convert_fairseq_state_dict(
        load_checkpoint_state_dict(fake_xlsr_pt), JXLSRConfig.tiny())
    assert (jax.tree_util.tree_structure(saved)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(saved),
                    jax.tree_util.tree_leaves(want)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    graft_pretrained_xlsr(XLSREncoder(XLSRConfig.tiny()), path)


def test_failing_ref_eer_gate_exits_1(
        gate_run, la_tree, fake_xlsr_pt, capsys, monkeypatch):  # noqa: F811
    """An impossible reference EER fails the eer stage and the run (the
    trained checkpoint reused, int8 skipped)."""
    root, _ = la_tree
    monkeypatch.chdir(gate_run[2])  # oc_classifier's 1c artefacts
    _, _, workdir = gate_run
    rc = parity_gate.main(_gate_argv(
        root, None, fake_xlsr_pt, workdir, "--skip_train", "--skip_int8",
        "--ref_eer", "0.9", "--gate", "0.001"))
    out = capsys.readouterr().out
    summary = _summary(out)
    assert rc == 1
    assert summary["stages"]["eer"]["ok"] is False
    assert "GATE eer FAIL" in out and "int8" not in summary["stages"]


def test_unreadable_checkpoint_fails_the_convert_stage(
        la_tree, tmp_path, capsys):  # noqa: F811
    root, _ = la_tree
    bad = tmp_path / "broken.pt"
    bad.write_bytes(b"not a checkpoint")
    rc = parity_gate.main(_gate_argv(root, None, str(bad),
                                     tmp_path / "gate"))
    out = capsys.readouterr().out
    assert rc == 1 and "GATE convert FAIL" in out
    assert _summary(out) == {"stages": {"convert": {
        "ok": False, "detail": _summary(out)["stages"]["convert"][
            "detail"]}}, "ok": False}
