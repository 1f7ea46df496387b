"""Logging and metrics (the port's copy of ``vaenar_tts_tpu/utils/logging.py``):

* ``Logger``: stdout teed into ``{log_dir}/train.log``;
* ``MetricsWriter``: per-epoch scalars as one JSON line each,
  ``{"step", "time", <name>: value, ...}``, in ``{dir}/metrics.jsonl``, and
  as TensorBoard scalars too when ``torch.utils.tensorboard`` imports (it
  needs the ``tensorboard`` package; without it the JSONL file is all);
* ``StepTimer``: wall-clock laps.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict


class Logger:
    """Tee stdout into a log file."""

    def __init__(self, log_dir: str, filename: str = "train.log"):
        os.makedirs(log_dir, exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(os.path.join(log_dir, filename), "a")

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self) -> None:
        self.terminal.flush()
        self.log.flush()

    def install(self) -> "Logger":
        sys.stdout = self
        return self

    def uninstall(self) -> None:
        """Put the previous stdout back and close the file."""
        if sys.stdout is self:
            sys.stdout = self.terminal
        self.log.close()


def _try_tensorboard(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = _try_tensorboard(log_dir) if use_tensorboard else None

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            name = f"{prefix}{k}" if prefix else k
            rec[name] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(name, float(v), int(step))
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class StepTimer:
    """Wall-clock step and epoch laps."""

    def __init__(self):
        self.start = time.time()

    def lap(self) -> float:
        now = time.time()
        dur = now - self.start
        self.start = now
        return dur
