#!/usr/bin/env python3
"""Where the time goes in the port's fused spatial-attention kernel (K6,
`dvdgan_tpu_torch/kernels/csrc/attention_spatial.cu`), bf16.

    python3 tools/torch_k6_phases.py        # from the repository root; one GPU

At the three shapes the driven paths give its narrow bodies (32²×64:
logits in registers, C 64; 32²×256: in registers, C 256; 64²×64: three
key sweeps) and the five wide calls of `--ch 96` (mode 4: 32²×384 of P2,
32²×1024, 64²×384; mode 3: 16²×768, 8²×1536) it prints one JSON line each
with:

  * the profiler's view of one call (`chip_smoke.device_view`: the device
    µs of attn_kv_kernel and attn_fwd_kernel, None where it missed a
    launch) and the call's CUDA-event ms;
  * the mean cycles a warp spends in each phase of a work item (16 query
    rows) of the second launch: staging the frame's k and v (the wait at a
    frame change, shared by the CTA's warps); q = x Wq (x read from global
    memory); the logits (sweep body: the max sweep); the softmax (sweep: the
    sum sweep); attn v (sweep: the third sweep with its logits and exps);
    o Wo with the residual and the store. The wide bodies (modes 3 and 4)
    stage nothing at a frame change (their "stage" is the next item's x
    prefetch); mode 3 counts q with the logits; mode 4's logits are its
    max sweep, or on 32² maps all of them formed once, and its attn_v holds
    its third sweep where it has one. Theirs also, a warp item: `ring_wait`, the cycles a warp
    waits for a tile of the ring of shared tiles; `turn_wait` and
    `turn_issue`, the cycles it waits, at its turn to copy a tile, for the
    stage to be released and then spends issuing the copies (all three
    inside the phases' cycles); and `tiles`, a CTA item's. From a build
    with -DK6_PROFILE
    (nvcc by hand, into a temporary directory), in which lane 0 of every
    warp adds clock64() laps to a device array. A warp's laps include the
    time it waits on the others sharing its SM sub-partition: the shares,
    not the sums, are what to read.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from dvdgan_tpu_torch.kernels import _build  # noqa: E402
from dvdgan_tpu_torch.kernels import attention_spatial as k6  # noqa: E402

PHASES = ("stage", "q", "logits", "softmax", "attn_v", "out")
SHAPES = [(256, 32, 32, 64), (384, 32, 32, 256), (192, 64, 64, 64),
          (96, 32, 32, 384), (32, 32, 32, 1024), (96, 64, 64, 384),
          (96, 16, 16, 768), (96, 8, 8, 1536)]


def build_profiled(tmp: str) -> ctypes.CDLL:
    out = os.path.join(tmp, "libattention_spatial_profile.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DK6_PROFILE", "-o", out,
           str(_build.CSRC / "attention_spatial.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = k6.bind(ctypes.CDLL(out))
    lib.spatial_attn_profile.argtypes = [ctypes.c_void_p]
    lib.spatial_attn_profile.restype = ctypes.c_int
    return lib


def inputs(n, h, w, c, device):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, h, w, c, generator=gen).to(device, torch.bfloat16)
    ws = [(a ** -0.5 * torch.randn(a, b, generator=gen)).to(
        device, torch.bfloat16)
        for a, b in ((c, c // 8), (c, c // 8), (c, c // 2), (c // 2, c))]
    return (x, *ws, torch.tensor(0.7, device=device))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k6_phases: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    rows = {}
    for n, h, w, c in SHAPES:
        args = inputs(n, h, w, c, device)

        def call(args=args):
            return k6.spatial_attn_fused(*args)

        view = chip_smoke.device_view(call, k6.LAUNCHES_PER_CALL,
                                      chip_smoke.ATTN_KERNELS)
        rows[(n, h, w, c)] = {
            "launch_device_us": view["launch_device_us"],
            "device_ms": view["device_ms"], "ms": chip_smoke.cuda_ms(call)}
    lib_of = k6._lib
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_profiled(tmp)
        k6._lib = lambda: lib
        counts = (ctypes.c_ulonglong * 12)()
        try:
            for n, h, w, c in SHAPES:
                args = inputs(n, h, w, c, device)
                for _ in range(2):          # the second run is the one read
                    k6.spatial_attn_fused(*args)
                    err = lib.spatial_attn_profile(counts)
                    if err:
                        raise RuntimeError(f"spatial_attn_profile: {err}")
                plan = k6.plan(torch.bfloat16, n, h, w, c, c // 8, c // 2)
                items, frames = counts[6], counts[7]
                per_item = {p: round(v / items)
                            for p, v in zip(PHASES, counts)}
                wide = k6.BODIES[plan.body][0] >= 3
                ring = ({"ring_wait": round(counts[8] / items),
                         "tiles": counts[9] * (plan.tq // 16) // items,
                         "turn_wait": round(counts[10] / items),
                         "turn_issue": round(counts[11] / items)}
                        if wide else {})
                print(json.dumps({
                    "shape": [n, h, w, c], "body": k6.BODIES[plan.body],
                    "queries_per_item": plan.tq, "ctas": plan.ctas,
                    "warp_items": items, "frames_staged": frames,
                    "cycles_per_warp_item": per_item,
                    "sum": sum(per_item.values()), **ring,
                    **rows[(n, h, w, c)]}), flush=True)
        finally:
            k6._lib = lib_of
    return 0


if __name__ == "__main__":
    sys.exit(main())
