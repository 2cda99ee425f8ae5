"""Training metrics: a JSONL history, plus TensorBoard where it is installed.

Port of ``gobblet_rl_tpu/train/logging.py``.  Every record is appended to
``<logdir>/history.jsonl``; numeric fields also go to a TensorBoard
``SummaryWriter`` when ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, logdir: str, args: dict | None = None):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.jsonl_path = os.path.join(logdir, "history.jsonl")
        self._step = 0
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(logdir)
            if args:
                self.writer.add_text("args", json.dumps(args, default=str))
        except ImportError:  # no tensorboard: JSONL only
            pass

    def log(self, record: dict, step: int | None = None) -> None:
        step = step if step is not None else record.get("grad_steps", self._step)
        self._step = step + 1
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"time": time.time(), **record}) + "\n")
        if self.writer is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(k, v, step)
            self.writer.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def make_logger(logdir: str, args: dict | None = None) -> MetricsLogger:
    return MetricsLogger(logdir, args)
