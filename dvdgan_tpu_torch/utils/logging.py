"""Scalar curves and the stdout one-liner — the counterpart of
`dvdgan_tpu/utils/logging.py`.

`MetricWriter(log_dir)` appends one {"step", "tag", "value", "ts"} record a
line to `log_dir/scalars.jsonl` (the same keys as the reference's), and
writes TensorBoard events too where `torch.utils.tensorboard` imports (it
needs the `tensorboard` package, which a card's machine may lack: then the
JSONL file is the only record).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                           buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"step": int(step), "tag": tag, "value": float(value),
             "ts": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            self.scalar(k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """A MetricWriter that writes nothing (a process that does not lead)."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def scalars(self, metrics: dict, step: int) -> None:
        pass

    def close(self) -> None:
        pass


def step_line(step: int, metrics: dict, steps_per_sec: Optional[float] = None
              ) -> str:
    """The reference's per-step stdout one-liner:
    `step 10 | d_loss 1.2345 | ... | steps/s 3.210`."""
    parts = [f"step {step}"]
    parts += [f"{k} {float(v):.4f}" for k, v in sorted(metrics.items())]
    if steps_per_sec is not None:
        parts.append(f"steps/s {steps_per_sec:.3f}")
    return " | ".join(parts)


def parse_step_line(line: str) -> tuple[int, dict[str, float]]:
    """(step, {name: value}) of a `step_line`, with any `name value` parts
    appended after it (the trainer's kernel launches)."""
    head, *parts = line.split(" | ")
    return int(head.split()[1]), {k: float(v) for k, v in
                                  (p.rsplit(" ", 1) for p in parts)}
