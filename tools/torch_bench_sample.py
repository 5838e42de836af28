#!/usr/bin/env python3
"""Serving throughput of the port: EMA-G sampling clips/s at the flagship
config (`ucf101_64`: 64×64×16 frames, ch 32, bf16, the seeded init
weights) — the counterpart of `tools/bench_sample.py`.

The reference scans SCAN_STEPS draws inside one jit. Here one CUDA graph
holds SCAN_STEPS calls of `train.step.sample` (each its SN pass and G's
forward), each call reading its z and y from static device buffers that
are filled with new draws before each replay (a value the host made
would be frozen into the graph); the clips' means are summed into one
scalar, which each timed call reads back. CALLS replays are timed after a
warm-up call and the capture; the same calls run eagerly beside them.

    python tools/torch_bench_sample.py [batch ...] [--device cuda|cpu]
        [model flags of the port's CLI]     (default batches: 8 16 32)

Prints one line per batch in the reference's format (clips/s, ms/clip,
ms/batch: the graph's on the card), with the eager rate of the same calls
beside it; `--device cpu` runs eagerly only.
"""

from __future__ import annotations

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

SCAN_STEPS = 10
CALLS = 3


class Draws:
    """SCAN_STEPS draws of (z, y) for batch b in static device buffers,
    refilled in place from a device generator."""

    def __init__(self, b: int, z_dim: int, n_classes: int, dtype, device,
                 seed: int = 0):
        self.n_classes = n_classes
        self.gen = torch.Generator(device).manual_seed(seed)
        self.z = torch.empty((SCAN_STEPS, b, z_dim), dtype=dtype,
                             device=device)
        self.y = torch.empty((SCAN_STEPS, b), dtype=torch.long, device=device)
        self.fill()

    def fill(self) -> None:
        self.z.normal_(generator=self.gen)
        self.y.random_(0, self.n_classes, generator=self.gen)


def scan(call, draws: Draws) -> torch.Tensor:
    """SCAN_STEPS calls of `call(z, y) -> clips`, the clips' means summed
    (a data dependency on every call, as the reference's scan carries)."""
    total = torch.zeros((), dtype=torch.float32, device=draws.z.device)
    for i in range(SCAN_STEPS):
        total = total + call(draws.z[i], draws.y[i]).float().mean()
    return total


def graphed(call, draws: Draws):
    """One CUDA graph of `scan(call, draws)`, captured after a warm-up scan
    on a side stream (as the capture wants it); -> a function that replays
    it and returns the scan's total."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan(call, draws)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        total = scan(call, draws)

    def replay():
        graph.replay()
        return total
    return replay


def seconds_per_call(run, draws: Draws, calls: int = CALLS) -> float:
    """Host seconds per sample call of `run` (one scan of SCAN_STEPS calls,
    eager or `graphed`), over `calls` runs after a warm-up run, each after
    a refill of `draws` and with its total read back."""
    float(run())
    t0 = time.perf_counter()
    for _ in range(calls):
        draws.fill()
        float(run())
    return (time.perf_counter() - t0) / (calls * SCAN_STEPS)


def line(b: int, dt: float) -> str:
    """The reference's line for batch b at dt seconds a batch."""
    return (f"batch {b:3d}: {b / dt:8.1f} clips/s  "
            f"({dt / b * 1e3:6.2f} ms/clip, {dt * 1e3:7.2f} ms/batch)")


def main(argv=None) -> list[dict]:
    from dvdgan_tpu_torch.models.generator import GeneratorState
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.train.trainer import resolve_device
    from dvdgan_tpu_torch.utils import config as config_mod

    parser = config_mod.build_parser()
    parser.add_argument("batches", type=int, nargs="*", default=[8, 16, 32])
    args = parser.parse_args(["--preset", "ucf101_64",
                              *(sys.argv[1:] if argv is None else argv)])
    cfg = config_mod.config_from_args(args)
    device = resolve_device(cfg.device)
    g_cfg = cfg.g_config()
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    trees = GeneratorState.create(g_cfg, cfg.seed).to(device).trees()

    def call(z, y):
        return step.sample(*trees, z, y, g_cfg)

    out = []
    for b in args.batches:
        draws = Draws(b, g_cfg.z_dim, g_cfg.n_classes, dtype, device)
        eager = seconds_per_call(functools.partial(scan, call, draws), draws)
        row = {"batch": b, "eager_s": eager}
        if device.type == "cuda":
            row["graph_s"] = seconds_per_call(graphed(call, draws), draws)
            print(f"{line(b, row['graph_s'])}  [graph]  eager "
                  f"{line(b, eager).split(': ', 1)[1]}", flush=True)
        else:
            print(f"{line(b, eager)}  [eager]", flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
