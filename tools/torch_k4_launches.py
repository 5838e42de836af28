#!/usr/bin/env python3
"""Device time of the port's single GRU step (K4), bf16, at the one-launch
planes of the driven presets (ucf101_64's 4² and 8² at B 16,
kinetics_256_48f's at B 2): for each shape, K4's cluster form at each
cluster size it takes of 4, 8 and 16, and K1's gate + candidate pair (the
two-launch form) at the same shape. Each line holds the profiler's view of
one call (`chip_smoke.device_view`: device µs of each kind of launch, the
call's device ms, None where the profiler missed a launch), the CUDA-event
ms of a wrapper call and of the launches alone, back to back
(`chip_smoke.launches_ms`), each the median of its repeats.

    python3 tools/torch_k4_launches.py [--tree DIR] [--tag NAME]

`--tree` imports `dvdgan_tpu_torch` from another checkout (e.g. the parent
commit unpacked with `git archive` into a git-ignored directory); the
measuring code is this checkout's. One GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (imports no part of the port)

SHAPES = [(chip_smoke.B, h, w, c) for h, w, c in chip_smoke.LEVELS[:2]] + [
    (chip_smoke.LONG_B, h, w, c) for h, w, c in chip_smoke.LONG_LEVELS[:2]]
NAMES = chip_smoke.CONVGRU_KERNELS + ("cell_cluster_kernel",
                                      "cell_plane_kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from dvdgan_tpu_torch.kernels import convgru_cell as k4
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    if not torch.cuda.is_available():
        print("torch_k4_launches: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), flush=True)
    plan = k4.plan
    for b, h, w, c in SHAPES:
        gx, cx, h0, wg, wc = chip_smoke.k1_inputs(h, w, c, torch.bfloat16,
                                                  dev, seed=0, b=b, t=1)
        cell = (gx[0], cx[0], h0, wg, wc)
        forms = {f"cluster{k}": k for k in (4, 8, 16)
                 if k4.cluster_tiles(h, w, c, k) is not None}
        for name, k in [*forms.items(), ("k1_pair", None)]:
            if k is None:
                call = functools.partial(k1.gru_sequence_fused, gx, cx, h0,
                                         wg, wc)
                alone = chip_smoke.k1_pair_launches((gx, cx, h0, wg, wc))
                n = 2
            else:
                k4.plan = functools.partial(plan, force_cluster=k)
                call = functools.partial(k4.gru_cell_fused, *cell)
                alone = chip_smoke.k4_launches(cell, k)
                n = 1
            try:
                view = chip_smoke.device_view(call, n, NAMES)
                row = {"shape": [b, h, w, c], "form": name, **view,
                       "event_ms": chip_smoke.cuda_ms(call, 20),
                       "launches_ms": chip_smoke.launches_ms(alone)}
            finally:
                k4.plan = plan
            print(args.tag, json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
