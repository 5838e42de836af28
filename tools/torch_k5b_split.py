#!/usr/bin/env python3
"""K5b's two launches apart: where the fused upsample conv's backward
(`dvdgan_tpu_torch/kernels/csrc/ups2x_fused.cu`) spends its time.

    python3 tools/torch_k5b_split.py        # from the repository root; one GPU

At each upsample level of the long-clip preset (kinetics_256_48f, N = 96
frames: one G micro-batch) and in bf16, runs `ups2x_bwd` through the
package's own wrapper, reads each launch's device time from torch.profiler
(`ups2x_dx_kernel`: dxp; `ups2x_dw_kernel`: dwall; `other`: the wrapper's
transposes and zero fills) and holds both outputs against the plain version
(max|err| / max|ref| per output). Prints one JSON line per level, after the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from dvdgan_tpu_torch.kernels import ups2x_fused as k5  # noqa: E402

# (H, W, Cin, Cout) of each long-clip upsample conv's source plane
LEVELS = [(4, 4, 512, 512), (8, 8, 512, 256), (16, 16, 256, 256),
          (32, 32, 256, 128), (64, 64, 128, 64), (128, 128, 64, 32)]
N, REPS = 96, 5
LAUNCHES = ("ups2x_dx_kernel", "ups2x_dw_kernel")


def inputs(h, w, cin, cout, device, seed):
    gen = torch.Generator().manual_seed(seed)
    wall = (4 * cin) ** -0.5 * torch.randn(4 * cin, 4 * cout, generator=gen)
    x = torch.relu(torch.randn(N, h, w, cin, generator=gen))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    g = torch.randn(N, 2 * h, 2 * w, cout, generator=gen)
    return [t.to(device, torch.bfloat16).contiguous() for t in (wall, xp, g)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k5b_split: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    device = torch.device("cuda", 0)
    for i, (h, w, cin, cout) in enumerate(LEVELS):
        wall, xp, g = inputs(h, w, cin, cout, device, seed=60 + i)
        ref = k5.ups2x_bwd_reference(wall, xp, g)
        out = k5.ups2x_bwd(wall, xp, g)
        for _ in range(2):
            k5.ups2x_bwd(wall, xp, g)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                k5.ups2x_bwd(wall, xp, g)
            torch.cuda.synchronize()
        ms = dict.fromkeys((*LAUNCHES, "other"), 0.0)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            key = next((k for k in LAUNCHES if k in e.key), "other")
            ms[key] += e.self_device_time_total / REPS / 1e3
        rel = {name: float((o - r).abs().max() / r.abs().max())
               for name, o, r in zip(("dwall", "dxp"), out, ref)}
        print(json.dumps({"shape": [N, h, w, cin, cout], "ms": ms,
                          "max_rel_err": rel}), flush=True)
        del wall, xp, g, ref, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
