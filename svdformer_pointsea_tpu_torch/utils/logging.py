"""Scalar logging and step timing (semantics of
svdformer_pointsea_tpu/utils/logging.py): an append-only JSONL stream of
scalars always, tensorboardX event files too when it is importable."""

from __future__ import annotations

import json
import os
import time


class SummaryLogger:
    """``add_scalar(tag, value, step)`` into ``<log_dir>/scalars.jsonl``
    (and a tensorboardX ``SummaryWriter`` when available)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:  # tensorboardX absent or broken: JSONL only
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Host wall-clock split of each batch into data time (waiting for the
    loader) and batch time (data plus the step's host work)."""

    def __init__(self):
        self._t = time.time()
        self.data_time = 0.0
        self.batch_time = 0.0

    def reset(self) -> None:
        """Re-arm at an epoch's start, so validation and checkpoint time do
        not count as the next batch's data time."""
        self._t = time.time()

    def mark_data(self) -> None:
        now = time.time()
        self.data_time = now - self._t
        self._t = now

    def mark_batch(self) -> None:
        now = time.time()
        self.batch_time = now - self._t + self.data_time
        self._t = now
