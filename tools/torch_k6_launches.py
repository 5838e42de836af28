#!/usr/bin/env python3
"""Device time of the port's fused spatial attention (K6), bf16, at the six
calls of the driven paths, the two 8² calls of `kinetics_128 --attn_res 8`
(C 512: the wide body) and at two 64² calls of wider attention
(`kinetics_256_48f --attn_res 64`, C 128, and C 256), whose frame k and vᵀ
the bf16 kernel reads from L2, and at the shapes of `chip_smoke.py`'s
K6_DOMAIN_SHAPES (the 4² map, P1's and P2's calls, the wide widths): for
each shape one JSON line with the
profiler's view of one call (`chip_smoke.device_view`: device µs of
`attn_kv_kernel` and `attn_fwd_kernel`, the call's device ms, None where
the profiler missed a launch), the call's CUDA-event ms and the `off`
route's spatial pass (`library_ms`), each the median of 10.

    python3 tools/torch_k6_launches.py [--tree DIR] [--tag NAME]
        [--shapes all|wide] [--save FILE | --against FILE]

`--tree` imports `dvdgan_tpu_torch` from another checkout (e.g. the parent
commit unpacked with `git archive` into a git-ignored directory); the
measuring code is this checkout's. Two trees can so be timed in turns, in
one process call each: change, parent, parent, change. One GPU.
`--shapes wide` times only the calls of the wide bodies (modes 3 and 4:
the wide widths of K6_DOMAIN_SHAPES, 32²×1024 and the 8² calls at C 512).
`--save` writes each call's output to FILE (torch.save, keyed by shape);
`--against` reads such a file and adds to each line how many output
elements differ from it (`differ_from_saved`): two trees' bits compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (imports no part of the port)

L2_SHAPES = [(96, 64, 64, 128), (48, 64, 64, 256)]
# the wide sweep (mode 4) at 32²×1024, the card tests' DOMAIN_SHAPES width
WIDE_EXTRA = [(32, 32, 32, 1024)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--shapes", choices=("all", "wide"), default="all")
    io = ap.add_mutually_exclusive_group()
    io.add_argument("--save")
    io.add_argument("--against")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.ops import attention
    if not torch.cuda.is_available():
        print("torch_k6_launches: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    domain = [s for shapes in chip_smoke.K6_DOMAIN_SHAPES.values()
              for s in shapes]
    shapes = (chip_smoke.K6A_SHAPES + chip_smoke.K6B_SHAPES
              + chip_smoke.K6A_WIDE_SHAPES + L2_SHAPES + domain + WIDE_EXTRA)
    if args.shapes == "wide":
        shapes = [s for s in shapes if s[3] >= 384 or s[1:] == (8, 8, 512)]
    saved = torch.load(args.against) if args.against else None
    outs = {}
    for n, h, w, c in shapes:
        call_args = chip_smoke.k6_inputs(n, h, w, c, torch.bfloat16, dev,
                                         seed=0)
        fn = (k6.spatial_attn_tiled if attention.uses_tiled(h, w)
              else k6.spatial_attn_fused)
        out = fn(*call_args).cpu()
        key = f"{n}x{h}x{w}x{c}"
        bits = {}
        if args.save:
            outs[key] = out
        if saved is not None:
            bits["differ_from_saved"] = int((out != saved[key]).sum())
        view = chip_smoke.device_view(lambda: fn(*call_args), 2,
                                      chip_smoke.ATTN_KERNELS)
        p = {"spatial": dict(zip(("theta", "phi", "g", "out"),
                                 ({"w": a} for a in call_args[1:5])),
                             gamma=call_args[5])}
        print(args.tag, json.dumps({
            "shape": [n, h, w, c], **view,
            "event_ms": chip_smoke.cuda_ms(lambda: fn(*call_args)),
            "library_ms": chip_smoke.cuda_ms(
                lambda: attention.spatial_attn(p, call_args[0])), **bits}),
            flush=True)
    if args.save:
        torch.save(outs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
