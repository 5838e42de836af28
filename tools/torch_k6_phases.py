#!/usr/bin/env python3
"""Where a query tile's time goes in the port's fused spatial-attention
kernel (K6, `dvdgan_tpu_torch/kernels/csrc/attention_spatial.cu`).

    python3 tools/torch_k6_phases.py        # from the repository root; one GPU

Builds the source once more with -DK6_PROFILE (nvcc by hand, into a
temporary directory), in which `attn_fwd_kernel` adds the cycles thread 0 of
every CTA spends in each of its eight phases to a device array, runs the
kernel through the package's own wrapper at the shapes the driven paths give
it, and prints one JSON line per shape and dtype: the mean cycles per CTA
and phase (staging of x and Wq^T; q = x Wq; the f32 logits; the softmax; the
wait for v^T; attn v; staging of a large Wo^T; o Wo with the residual and
the store). The marks add a block barrier per phase; the shares, not the
sum, are what to read.
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
from dvdgan_tpu_torch.kernels import _build  # noqa: E402
from dvdgan_tpu_torch.kernels import attention_spatial as k6  # noqa: E402

PHASES = ("stage", "q", "logits", "softmax", "wait_v", "attn_v", "stage_wo",
          "out")
SHAPES = [(256, 32, 32, 64), (384, 32, 32, 256), (192, 64, 64, 64)]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k6_phases: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_profiled(tmp)
        k6._lib = lambda: lib
        cycles = (ctypes.c_ulonglong * len(PHASES))()
        for dtype in (torch.bfloat16, torch.float32):
            for n, h, w, c in SHAPES:
                gen = torch.Generator().manual_seed(0)
                x = torch.randn(n, h, w, c, generator=gen).to(device, dtype)
                ws = [(a ** -0.5 * torch.randn(a, b, generator=gen)
                       ).to(device, dtype)
                      for a, b in ((c, c // 8), (c, c // 8), (c, c // 2),
                                   (c // 2, c))]
                gamma = torch.tensor(0.7, device=device)
                for _ in range(2):          # the second run is the one read
                    k6.spatial_attn_fused(x, *ws, gamma)
                    err = lib.spatial_attn_profile(cycles)
                    if err:
                        raise RuntimeError(f"spatial_attn_profile: {err}")
                tq = lib.spatial_attn_plan(k6._DTYPE_CODES[dtype], h, w, c,
                                           c // 8, c // 2, 0)
                ctas = n * h * w // tq
                per_cta = {p: round(v / ctas) for p, v in zip(PHASES, cycles)}
                print(json.dumps({
                    "dtype": str(dtype).replace("torch.", ""),
                    "shape": [n, h, w, c], "queries_per_cta": tq,
                    "ctas": ctas, "cycles_per_cta": per_cta,
                    "sum": sum(per_cta.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
