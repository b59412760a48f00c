"""Training observability (port of `occm_tpu.utils.logging`).

- `loss.txt` running-average lines every `log_every` steps, format-exact
  with the reference (oc_training.py:391-395),
- a JSONL stream of the same numbers (metrics.jsonl).
wandb is not ported (TrainConfig.wandb_project raises).
"""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, loss_txt: Optional[str] = "loss.txt",
                 jsonl: Optional[str] = "metrics.jsonl"):
        self.loss_txt = loss_txt
        self.jsonl = jsonl

    def log_running(self, epoch: int, i: int, running_loss: float,
                    running_closs: float, running_dloss: float) -> None:
        """Running-average line, format-exact with the reference (note the
        trailing space before the newline)."""
        denom = i + 1
        if self.loss_txt:
            with open(self.loss_txt, "a") as f:
                f.write(
                    f"epoch = {epoch + 1}, i = {i + 1}, "
                    f"loss = {running_loss / denom:.3f}, "
                    f"closs = {running_closs / denom:.3f}, "
                    f"dloss = {running_dloss / denom:.3f} \n"
                )

    def log_jsonl(self, **record) -> None:
        if not self.jsonl:
            return
        record.setdefault("time", time.time())
        with open(self.jsonl, "a") as f:
            f.write(json.dumps(record) + "\n")
