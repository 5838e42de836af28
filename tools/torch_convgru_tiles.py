#!/usr/bin/env python3
"""K1 and K2 under each tensor-core tile: the sweep behind the plan's tile
rule (`dvdgan_tpu_torch/kernels/convgru_seq.py:plan`, `SMALL_STEP`).

    python3 tools/torch_convgru_tiles.py     # from the repository root; one GPU

At the GRU level shapes of the driven presets (T 48; B 2, 8 and 16), in
bf16, runs K1 (`gru_sequence_fused`) and K2 (`gru_sequence_bwd`) first with
the plan's own tile, then with each tile of `MMA_TILES` forced (the plan's
rule for slices kept: at least 132 CTAs where the tiles are fewer), and
prints one JSON line per (shape, tile) after the card's name and power
limit: each call's CUDA-event ms (median of 3) and the device µs of each
kind of K2 launch from torch.profiler (its epilogue: GateEpi, CandBwdEpi,
DrhEpi, DhEpi).
"""

from __future__ import annotations

import json
import os
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from dvdgan_tpu_torch.kernels import convgru_bwd as k2  # noqa: E402
from dvdgan_tpu_torch.kernels import convgru_seq as k1  # noqa: E402

T = 48
# (B, H, W, C): the long-clip levels at B 2 and the fake pass's B 8, the
# flagship's small planes at B 16
SHAPES = [(2, 4, 4, 512), (8, 4, 4, 512), (2, 8, 8, 512), (8, 8, 8, 512),
          (2, 16, 16, 256), (8, 16, 16, 256), (2, 32, 32, 256),
          (8, 32, 32, 256), (2, 64, 64, 128), (2, 128, 128, 64),
          (16, 4, 4, 256), (16, 8, 8, 256)]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


PLAN = k1.plan       # the package's own, before any tile is forced


def forced(tile):
    """The plan with the tile `tile` (None: the plan's own)."""

    def forced_plan(b, h, w, c, launch):
        base = PLAN(b, h, w, c, launch)
        if tile is None:
            return base
        tf, th, tw, bn, _ = k1.MMA_TILES[tile]
        m = cdiv(b, tf) * cdiv(h, th) * cdiv(w, tw)
        n = cdiv(base.cout, bn)
        slices = (1 if m * n >= k1.MIN_CTAS
                  else min(base.ksteps, cdiv(k1.MIN_CTAS, m * n)))
        return k1.Plan(tile, m, n, slices, base.ksteps, base.pixels,
                       base.cout)

    return forced_plan


def launch_us(fn) -> dict:
    """Mean device µs of each kind of tensor-core launch of one fn() call
    (a warm-up call traced first, as `chip_smoke.device_view` does)."""
    kept = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return {chip_smoke.launch_kind(e.key): round(
        e.self_device_time_total / e.count, 1) for e in kept[0]
            if e.device_type == DeviceType.CUDA and "conv3x3_mma" in e.key}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_convgru_tiles: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), flush=True)
    try:
        for b, h, w, c in SHAPES:
            args = chip_smoke.k1_inputs(h, w, c, torch.bfloat16, device, 0,
                                        b=b, t=T)
            hs = k1.gru_sequence_fused(*args)
            g = torch.randn(hs.shape, device=device).to(torch.bfloat16)
            for tile in (None, *range(len(k1.MMA_TILES))):
                k1.plan = forced(tile)
                row = {"shape": [T, b, h, w, c],
                       "tile": (f"plan {PLAN(b, h, w, c, 'gate').tile}"
                                if tile is None else tile),
                       "k1_ms": chip_smoke.cuda_ms(
                           lambda: k1.gru_sequence_fused(*args), 3, 1),
                       "k2_ms": chip_smoke.cuda_ms(
                           lambda: k2.gru_sequence_bwd(*args, hs, g), 3, 1),
                       "k2_launch_us": launch_us(
                           lambda: k2.gru_sequence_bwd(*args, hs, g))}
                print(json.dumps(row), flush=True)
    finally:
        k1.plan = PLAN
    return 0


if __name__ == "__main__":
    sys.exit(main())
