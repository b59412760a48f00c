"""The port's profiling hooks (`occm_tpu_torch.utils.profiling`) and
wandb logging (`occm_tpu_torch.utils.logging.MetricsLogger`) against the
JAX package's, on the CPU.

- One stub `wandb` module in sys.modules records the calls of both
  loggers: the same init arguments, the same metric names and values,
  and the same loss.txt; an init that fails, or no wandb to import,
  leaves both on loss.txt alone.
- `StepTimer` on the same clock readings gives JAX's summaries.
- `profile_trace` writes a trace under its logdir (TensorBoard's profiler
  layout, as jax.profiler's does) that names the ops run inside it.
- `train()` with `TrainConfig.wandb_project` opens the run and logs the
  running averages through it.
"""

import glob
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from occm_tpu.utils import logging as jlogging
from occm_tpu.utils import profiling as jprofiling
from occm_tpu_torch.utils import logging as tlogging
from occm_tpu_torch.utils import profiling as tprofiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stub_wandb(fail=False):
    calls = []
    mod = types.ModuleType("wandb")

    def init(**kw):
        calls.append(("init", kw))
        if fail:
            raise RuntimeError("no wandb login")

    mod.init = init
    mod.log = lambda record: calls.append(("log", record))
    return mod, calls


def _drive(logger_cls, directory):
    loss_txt = os.path.join(directory, "loss.txt")
    logger = logger_cls(loss_txt=loss_txt, jsonl=None, wandb_project="p",
                        wandb_entity="e")
    logger.log_running(0, 99, 250.0, 10.0, 240.0)
    logger.log_running(1, 199, 100.0, 5.0, 95.5)
    with open(loss_txt) as f:
        return f.read(), logger


@pytest.mark.parametrize("case", ["stub", "init_fails", "absent"])
def test_wandb_logging_is_jaxs(tmp_path, monkeypatch, case):
    seen = {}
    for side, cls in (("jax", jlogging.MetricsLogger),
                      ("port", tlogging.MetricsLogger)):
        if case == "absent":
            monkeypatch.setitem(sys.modules, "wandb", None)  # ImportError
            calls = []
        else:
            mod, calls = _stub_wandb(fail=case == "init_fails")
            monkeypatch.setitem(sys.modules, "wandb", mod)
        directory = tmp_path / side
        directory.mkdir()
        text, logger = _drive(cls, str(directory))
        seen[side] = (text, calls, logger._wandb is None)
    assert seen["port"] == seen["jax"]
    text, calls, off = seen["port"]
    assert text.startswith("epoch = 1, i = 100, loss = 2.500")
    if case == "stub":
        assert not off
        assert calls[0] == ("init", {"project": "p", "entity": "e"})
        assert calls[1] == ("log", {
            "Epoch": 0, "Train Loss": 2.5, "Train Compactness Loss": 0.1,
            "Train Descriptiveness Loss": 2.4})
        assert len(calls) == 3
    else:
        assert off


def test_step_timer_is_jaxs(monkeypatch):
    readings = np.cumsum([0.0, 0.5, 1.0, 0.25, 2.0, 0.125, 3.0, 0.5, 1.0,
                          0.75]).tolist()
    timers = []
    for module in (jprofiling, tprofiling):
        clock = iter(readings)
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=lambda: next(clock)))
        timer = module.StepTimer(warmup=2)
        for _ in range(5):
            with timer:
                pass
        timers.append((timer.times, timer.steady, timer.mean()))
    assert timers[0] == timers[1]
    assert timers[1][1] == [0.125, 0.5, 0.75]
    short = tprofiling.StepTimer(warmup=2)
    short.times = [0.5, 0.25]  # no more than the warm-up: all of them
    assert short.steady == short.times and short.mean() == 0.375


def test_profile_trace_writes_a_trace_naming_the_ops(tmp_path):
    a = torch.randn(64, 64)
    with tprofiling.profile_trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_train_logs_to_wandb_with_wandb_project(tmp_path, monkeypatch):
    """train() with cfg.wandb_project: the logger opens a run and logs the
    loss.txt averages to it (log_every 1)."""
    from occm_tpu_torch.config import AASISTConfig, TrainConfig, XLSRConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train.loop import train

    mod, calls = _stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", mod)
    rng = np.random.default_rng(0)
    batches = [((rng.normal(size=(12, 3200)) * 0.1).astype(np.float32),
                np.array([0] * 6 + [1] * 6)) for _ in range(2)]

    class Pipeline:
        def epoch(self, e):
            return iter(batches)

    torch.manual_seed(0)
    cfg = TrainConfig(lr=1e-3, cut=3200, log_every=1, wandb_project="proj",
                      loss_txt=str(tmp_path / "loss.txt"))
    train(AModel(AASISTConfig.tiny(), XLSRConfig.tiny()), Pipeline(), cfg,
          num_epochs=1, device="cpu")
    assert calls[0] == ("init", {"project": "proj", "entity": None})
    logged = [c[1] for c in calls[1:]]
    assert len(logged) == 2 and all(r["Epoch"] == 0 for r in logged)
    lines = (tmp_path / "loss.txt").read_text().splitlines()
    assert len(lines) == 2
    assert lines[1].startswith(
        f"epoch = 1, i = 2, loss = {logged[1]['Train Loss']:.3f}")
