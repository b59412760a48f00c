"""Training observability (port of `occm_tpu.utils.logging`).

- `loss.txt` running-average lines every `log_every` steps, format-exact
  with the reference (oc_training.py:391-395),
- optional wandb logging with the reference's metric names
  (oc_training.py:396): with `wandb_project` set, the logger imports
  wandb and starts a run; any failure there (wandb absent, no login, no
  network) leaves it logging to loss.txt and the jsonl stream only, as
  the JAX package's does,
- a JSONL stream of the same numbers (metrics.jsonl).
"""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, loss_txt: Optional[str] = "loss.txt",
                 jsonl: Optional[str] = "metrics.jsonl",
                 wandb_project: Optional[str] = None,
                 wandb_entity: Optional[str] = None):
        self.loss_txt = loss_txt
        self.jsonl = jsonl
        self._wandb = None
        if wandb_project:
            try:
                import wandb  # optional dependency

                wandb.init(project=wandb_project, entity=wandb_entity)
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log_running(self, epoch: int, i: int, running_loss: float,
                    running_closs: float, running_dloss: float) -> None:
        """Running-average line, format-exact with the reference (note the
        trailing space before the newline), and the same averages to
        wandb when a run is open."""
        denom = i + 1
        if self.loss_txt:
            with open(self.loss_txt, "a") as f:
                f.write(
                    f"epoch = {epoch + 1}, i = {i + 1}, "
                    f"loss = {running_loss / denom:.3f}, "
                    f"closs = {running_closs / denom:.3f}, "
                    f"dloss = {running_dloss / denom:.3f} \n"
                )
        if self._wandb:
            self._wandb.log({
                "Epoch": epoch,
                "Train Loss": running_loss / denom,
                "Train Compactness Loss": running_closs / denom,
                "Train Descriptiveness Loss": running_dloss / denom,
            })

    def log_jsonl(self, **record) -> None:
        if not self.jsonl:
            return
        record.setdefault("time", time.time())
        with open(self.jsonl, "a") as f:
            f.write(json.dumps(record) + "\n")
