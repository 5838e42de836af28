"""What a run hands between the harness, the entries and the metric
readers, and the judgement of the numbers a cell compares."""

from __future__ import annotations

import math
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

from port_bench.trace import Timeline

PEAK_BF16 = 989e12      # FLOP/s, one H100 SXM, dense bf16 tensor cores


@dataclass
class Ctx:
    """One run of one cell."""
    cell: str
    chips: int
    config: dict            # the configuration's file
    mix: dict               # the traffic's file
    limits: dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmp: Path               # the run's scratch directory, under TMPDIR
    started: float          # time.perf_counter() at the process's start

    @property
    def flags(self) -> dict:
        return self.config["flags"]

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


@dataclass
class Readings:
    """What the per-layer metric readers take, from a --trace 1 run: the
    traced window, the untraced window's time per unit of work (a train
    step or a sampler batch), and the counts from shapes."""
    units_traced: int           # steps or batches in the traced window
    unit_s: float               # untraced seconds per unit
    chips: int
    flops_per_unit: float       # the model's FLOPs per unit, all chips
    gru_bound_ms: float         # Σ K1, K2, K3 bounds per unit
    timeline: Timeline


@dataclass
class Outcome:
    """What an entry measured and judged."""
    e2e: dict[str, float]
    attempted: int
    failed: int
    numbers: dict[str, float]
    memory_peak_bytes: Optional[int]
    readings: Optional[Readings] = None
    notes: list[str] = field(default_factory=list)


def judge(numbers: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, dict[str, float]]]:
    """Each compared number against its limit; a number that is not
    finite, or that has no limit, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and math.isfinite(value)
                and value <= limit)
        ok &= good
        checks[name] = {"value": value,
                        "limit": limit if limit is not None else math.nan}
    for name in limits:
        if name not in numbers:
            ok = False
            checks[name] = {"value": math.nan, "limit": limits[name]}
    return ok, checks


def scratch() -> Path:
    """A fresh directory under TMPDIR for the run's out_dir."""
    return Path(tempfile.mkdtemp(prefix="port_bench_"))
