"""train(resume=True) beside orbax directories that are not the JAX
package's trainer checkpoints.

The JAX package writes its epoch and step checkpoints as orbax directories
`<prefix>_<epoch>` and `<prefix>_step_<n>` (occm_tpu/train/checkpoint.py),
from which the port's resume continues (tests/test_torch_resume_jax.py). A
directory of the prefix's name that holds weights only (here a
{"params", "step"} tree, no optimizer state) cannot be continued:
train(resume=True) raises a ValueError that names the directory, the
missing opt_state and --init_from (which starts from such a directory's
weights) instead of training from fresh weights beside it. The
directories are written with the port's own orbax writer (`train/orbax.py`
`save_tree`).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from occm_tpu_torch.config import AASISTConfig, RawBoostConfig, TrainConfig
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models import AModel
from occm_tpu_torch.train import train
from occm_tpu_torch.train.checkpoint import jax_checkpoint_dirs
from occm_tpu_torch.train.orbax import save_tree

PREFIX = "aasist_vocoded"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the model is tiny and the suite's workers share
    the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Reached(Exception):
    """Raised by the pipeline: training got as far as its first epoch."""


class Pipeline:
    def epoch(self, epoch):
        raise Reached
        yield  # a generator that raises on its first batch


def _jax_dir(directory, name):
    """A JAX-format checkpoint directory (a small params / step tree)."""
    return save_tree({"params": {"w": np.arange(6, dtype=np.float32)},
                      "step": np.int32(3)}, os.path.join(directory, name))


def _train(directory):
    cfg = TrainConfig(
        lr=1e-3, num_epochs=1, cut=1600, checkpoint_dir=str(directory),
        checkpoint_prefix=PREFIX, loss_txt=str(directory / "loss.txt"),
        rawboost=RawBoostConfig(algo=0))
    torch.manual_seed(0)
    xcfg = dataclasses.replace(XLSRConfig.tiny(), encoder_layers=1)
    return train(AModel(AASISTConfig.tiny(), xcfg), Pipeline(), cfg,
                 device="cpu", resume=True)


@pytest.mark.parametrize("names", [
    [f"{PREFIX}_0"], [f"{PREFIX}_step_3"], [f"{PREFIX}_1", f"{PREFIX}_0"]],
    ids=["epoch", "step", "two_epochs"])
def test_resume_beside_a_jax_checkpoint_names_init_from(tmp_path, names):
    """The prefix's epoch or step directories of weights only and no .pt of
    it: resume raises before any step, naming the newest directory, its
    missing opt_state and --init_from."""
    for name in names:
        _jax_dir(tmp_path, name)
    assert jax_checkpoint_dirs(str(tmp_path), PREFIX) == sorted(names)
    with pytest.raises(ValueError, match="--init_from") as err:
        _train(tmp_path)
    newest = str(tmp_path / names[0])
    assert f"{newest} holds weights only" in str(err.value)
    assert "no 'opt_state'" in str(err.value)


def test_resume_ignores_other_directories_and_prefixes(tmp_path):
    """A directory of the prefix's name that is not an orbax checkpoint, and
    another prefix's JAX checkpoint, are not the prefix's JAX run: resume
    finds nothing to restore and trains (the pipeline is reached)."""
    os.makedirs(tmp_path / f"{PREFIX}_0")
    _jax_dir(tmp_path, "ssl_resnet34_vocoded_0")
    with open(tmp_path / f"{PREFIX}_2.pt.tmp", "wb"):
        pass
    assert jax_checkpoint_dirs(str(tmp_path), PREFIX) == []
    assert jax_checkpoint_dirs(str(tmp_path / "absent"), PREFIX) == []
    with pytest.raises(Reached):
        _train(tmp_path)
