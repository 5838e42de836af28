#!/usr/bin/env python3
"""K3's bf16 body under each tile: the sweep behind the plan's tile rule
(`dvdgan_tpu_torch/kernels/convgru_blocked.py:plan`, `MIN_CTAS`).

    python3 tools/torch_k3_tiles.py     # from the repository root; one GPU

At every K3 level of the driven presets (kinetics_256_48f's 64²×128 and
128²×64 at T 48, B 2 and 8; kinetics_128's 64²×64 at T 12, B 8 and 16), in
bf16, runs K3 (`gru_sequence_blocked`) with each tile of `TILES` that fits
shared memory forced, and K1 (`gru_sequence_fused`) at the same shape, and
prints one JSON line per (shape, tile) after the card's name and power
limit: the tile's CTAs and shared memory, CUDA-event ms (median of 3),
TFLOP/s (the two convs without the rim), torch.profiler's device µs per
launch, whether it is the plan's tile, and K1's ms. Off `chip_smoke.py`'s
main path (~1 min on the card).
"""

from __future__ import annotations

import functools
import json
import os
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from dvdgan_tpu_torch.kernels import convgru_blocked as k3  # noqa: E402
from dvdgan_tpu_torch.kernels import convgru_seq as k1  # noqa: E402

# (T, B, H, W, C)
SHAPES = [(48, 2, 64, 64, 128), (48, 8, 64, 64, 128), (48, 2, 128, 128, 64),
          (48, 8, 128, 128, 64), (12, 8, 64, 64, 64), (12, 16, 64, 64, 64)]

PLAN = k3.plan       # the package's own, before any tile is forced


def launch_us(fn) -> float:
    """Mean device µs of K3's launches in one fn() call (a warm-up call
    traced first, as `chip_smoke.device_view` does)."""
    kept = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    rows = [e for e in kept[0] if e.device_type == DeviceType.CUDA
            and "blocked_mma_kernel" in e.key]
    n = sum(e.count for e in rows)
    return sum(e.self_device_time_total for e in rows) / n if n else 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_tiles: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), flush=True)
    try:
        for t, b, h, w, c in SHAPES:
            args = chip_smoke.k1_inputs(h, w, c, torch.bfloat16, device, 0,
                                        b=b, t=t)
            k1_ms = chip_smoke.cuda_ms(lambda: k1.gru_sequence_fused(*args),
                                       3, 1)
            for tile in range(len(k3.TILES)):
                p = PLAN(b, h, w, c, tile)
                if p.smem_bytes > k3.MAX_SMEM_BYTES:
                    continue
                k3.plan = functools.partial(PLAN, tile=tile)
                ms = chip_smoke.cuda_ms(lambda: k3.gru_sequence_blocked(*args),
                                        3, 1)
                row = {"shape": [t, b, h, w, c], "tile": tile,
                       "tile_px": list(k3.TILES[tile][:2]),
                       "plan": PLAN(b, h, w, c).tile == tile,
                       "ctas": p.ctas, "smem_bytes": p.smem_bytes, "ms": ms,
                       "tflops": chip_smoke.fwd_flops(t, b, h, w, c) / ms
                       / 1e9,
                       "launch_device_us": launch_us(
                           lambda: k3.gru_sequence_blocked(*args)),
                       "k1_ms": k1_ms}
                print(json.dumps(row), flush=True)
    finally:
        k3.plan = PLAN
    return 0


if __name__ == "__main__":
    sys.exit(main())
