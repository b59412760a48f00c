"""`oc_training --debug_nans` in the port (JAX's jax_debug_nans), on the
CPU at `--xlsr_tiny`, torch pinned to one thread.

JAX raises FloatingPointError from the first op that makes a NaN; the
port checks each step's loss and gradients (before the update) and its
updated parameters (after it), and raises FloatingPointError naming the
first tensor with a NaN, before the step is logged or checkpointed. On
finite data the flag changes no number (tests/test_torch_train.py's
`test_cli_unported_flags_raise[debug_nans]` holds a CLI epoch bit for
bit); without it a NaN run goes on, as in JAX.
"""

import struct

import numpy as np
import pytest
import torch

from occm_tpu_torch.config import AASISTConfig, TrainConfig, XLSRConfig
from occm_tpu_torch.models import AModel
from occm_tpu_torch.train import create_train_state, train_step
from occm_tpu_torch.train.checkpoint import latest_step_checkpoint
from occm_tpu_torch.train.loop import first_nan
from test_torch_train import _cli_args, write_fixture

CUT = 3200


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_float_wav(path, x, sr=16000):
    """IEEE float32 mono WAV (format 3), which can hold a NaN."""
    data = np.asarray(x, "<f4").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


@pytest.fixture
def nan_tree(tmp_path):
    """The CLI fixture tree with one bona fide utterance whose samples
    hold a NaN."""
    protocol, train_dir, voc_dir = write_fixture(tmp_path)
    wave = 0.3 * np.sin(2 * np.pi * 230 * np.arange(3000) / 16000)
    wave[100:110] = np.nan
    write_float_wav(f"{train_dir}/LA_T_b0003.wav", wave)
    return protocol, train_dir, voc_dir


def test_cli_debug_nans_raises_before_the_steps_checkpoint(
        tmp_path, monkeypatch, nan_tree):
    """Step checkpoints every step: the ones of the steps before the NaN
    step are written, that step's and the epoch's are not."""
    from occm_tpu_torch.cli import oc_training

    monkeypatch.chdir(tmp_path)
    ck = tmp_path / "ck"
    done = []
    with pytest.raises(FloatingPointError, match="NaN in the loss"):
        oc_training.main(
            _cli_args(*nan_tree, str(ck), "--debug_nans",
                      "--checkpoint_every_steps", "1"),
            on_step=lambda step, m: done.append(float(m["loss"])))
    assert np.all(np.isfinite(done))
    latest = latest_step_checkpoint(str(ck), "aasist_vocoded")
    assert latest == (len(done) or None)
    assert not (ck / "aasist_vocoded_0.pt").exists()
    assert len(done) < 6


def test_cli_without_debug_nans_goes_on(tmp_path, monkeypatch, nan_tree):
    from occm_tpu_torch.cli import oc_training

    monkeypatch.chdir(tmp_path)
    ck = tmp_path / "ck"
    losses = []
    oc_training.main(_cli_args(*nan_tree, str(ck)),
                     on_step=lambda step, m: losses.append(float(m["loss"])))
    assert len(losses) == 6 and np.isnan(losses).any()
    assert (ck / "aasist_vocoded_0.pt").is_file()


def _state(seed=0):
    torch.manual_seed(seed)
    xcfg = XLSRConfig.tiny()
    model = AModel(AASISTConfig.tiny(), xcfg)
    cfg = TrainConfig(lr=1e-3, cut=CUT, compactness_weight=0.1,
                      descriptiveness_weight=0.9)
    return create_train_state(model, cfg), cfg


def _batch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(12, CUT)) * 0.1).astype(
        np.float32))
    return x, torch.tensor([0] * 6 + [1] * 6)


def test_step_names_the_gradient_with_a_nan_and_keeps_the_weights():
    """A gradient hook that writes a NaN into one parameter's gradient
    (the loss stays finite): the step raises naming that gradient, before
    the update, so no weight moves."""
    state, cfg = _state()
    name, param = next((n, p) for n, p in state.named_params()
                       if n.endswith("out_layer.weight"))
    param.register_hook(lambda g: g.index_fill(0, torch.tensor([0]),
                                               float("nan")))
    before = {n: p.detach().clone() for n, p in state.named_params()}
    x, labels = _batch()
    with pytest.raises(FloatingPointError,
                       match=f"the gradient of {name} .before the update"):
        train_step(state, x, labels, cfg, debug_nans=True)
    for n, p in state.named_params():
        assert torch.equal(p, before[n]), n
    assert state.step == 0


def test_finite_step_with_the_flag_is_the_step_without_it():
    x, labels = _batch()
    runs = []
    for flag in (False, True):
        state, cfg = _state()
        m = train_step(state, x, labels, cfg, debug_nans=flag)
        runs.append((float(m["loss"]), {n: p.detach().clone()
                                        for n, p in state.named_params()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n


def test_first_nan_names_the_first_tensor_with_a_nan():
    t = torch.ones(3)
    nan = torch.tensor([1.0, float("nan")])
    assert first_nan([("a", t), ("b", None), ("c", torch.empty(0))]) is None
    assert first_nan([("a", t), ("b", nan), ("c", nan)]) == "b"
    # JAX's debug_nans checks NaNs, not infinities
    assert first_nan([("a", torch.tensor([float("inf")]))]) is None
