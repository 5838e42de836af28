#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dvdgan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one GPU

1. prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the port from csrc/ with nvcc (one process per source, all
   started together);
2. holds each kernel against its plain PyTorch version at the shapes EMA-G
   sampling gives it (K1 at the four ucf101_64 GRU levels, T=16, B=16), in
   f32 with TF32 off (atol 1e-4) and in bf16 (atol 3e-2), and times both
   (CUDA events, median of 10 runs after warm-up);
3. drives the sample entry (`python -m dvdgan_tpu_torch --mode sample
   --preset ucf101_64 --n_samples 16 --bf16 1`) with the launch counters
   zeroed just before, checks the clip (shape, finite, in [-1, 1]) and that
   every kernel of the path launched, then times sampling in clips/s and
   holds a small f32 sample on the card against the CPU (plain) path;
4. prints one JSON line of the kernels, then the result line.

Any failing phase raises, so the script exits non-zero without the result
line; so does a machine without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

LEVELS = [(4, 4, 256), (8, 8, 256), (16, 16, 128), (32, 32, 64)]  # H, W, C
T, B = 16, 16
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SAMPLE_TOL = 2e-3   # f32 clip, card vs CPU: cuDNN vs CPU conv sum order


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs(h: int, w: int, c: int, dtype, device, seed: int):
    g = torch.Generator().manual_seed(seed)
    scale = (9 * c) ** -0.5          # unit-gain 3×3 convs, as SN leaves them

    def rand(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g)).to(device, dtype)

    return (rand(T, B, h, w, 2 * c), rand(T, B, h, w, c),
            torch.tanh(rand(B, h, w, c)).contiguous(),
            rand(3, 3, c, 2 * c, s=scale), rand(3, 3, c, c, s=scale))


def check_k1(device) -> dict:
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (h, w, c) in enumerate(LEVELS):
            args = k1_inputs(h, w, c, dtype, device, seed=i)
            ref = k1.gru_sequence_reference(*args)
            out = k1.gru_sequence_fused(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [T, B, h, w, c],
                   "max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()),
                   "ms": cuda_ms(lambda: k1.gru_sequence_fused(*args)),
                   "plain_ms": cuda_ms(
                       lambda: k1.gru_sequence_reference(*args))}
            print("K1 " + json.dumps(row), flush=True)
            if not row["max_abs_err"] <= TOL[dtype]:
                raise AssertionError(f"K1 disagrees with its plain version: "
                                     f"{row} (atol {TOL[dtype]})")
            rows.append(row)
    return rows


def drive_sample(device) -> tuple[int, dict]:
    from dvdgan_tpu_torch import cli
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.models.generator import GeneratorState
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.utils.config import parse_config

    argv = ["--mode", "sample", "--preset", "ucf101_64", "--n_samples",
            str(B), "--bf16", "1"]
    cfg = parse_config(argv)
    g_cfg = cfg.g_config()
    with tempfile.TemporaryDirectory() as tmp:
        k1.gru_sequence_fused.launches = 0
        videos = cli.main(argv + ["--out_dir", tmp])
        launches = k1.gru_sequence_fused.launches
        saved = np.load(os.path.join(tmp, "samples.npy"))
    want_shape = (B, g_cfg.n_frames, g_cfg.img_size, g_cfg.img_size, 3)
    if videos.shape != want_shape or saved.shape != want_shape:
        raise AssertionError(f"sample shape {videos.shape}, want {want_shape}")
    if not np.isfinite(videos).all():
        raise AssertionError("non-finite values in the sampled clips")
    if videos.min() < -1.0 or videos.max() > 1.0:
        raise AssertionError(f"clip range [{videos.min()}, {videos.max()}]")
    want = g_cfg.n_levels * g_cfg.n_frames * k1.LAUNCHES_PER_STEP
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times in the sample "
                             f"run, want {want}")
    print(f"sample: shape {videos.shape} range [{videos.min():.4f}, "
          f"{videos.max():.4f}] K1 launches {launches}", flush=True)

    # steady-state serving rate, bf16 batch B (weights already on the card)
    state = GeneratorState.create(g_cfg, cfg.seed).to(device)
    trees = state.trees()
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(B, g_cfg.z_dim, generator=gen).to(device, torch.bfloat16)
    y = torch.randint(0, g_cfg.n_classes, (B,), generator=gen).to(device)
    for _ in range(2):
        step.sample(*trees, z, y, g_cfg)
    torch.cuda.synchronize()
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        step.sample(*trees, z, y, g_cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = statistics.median(secs)
    clips = {"batch": B, "dtype": "bfloat16", "ms_per_batch": sec * 1e3,
             "clips_per_s": B / sec}
    print("sample_rate " + json.dumps(clips), flush=True)

    # a small f32 sample: card (K1) against the CPU (plain K1 version)
    z2, y2 = z[:2].float(), y[:2]
    on_card = step.sample(*trees, z2, y2, g_cfg).cpu()
    cpu_trees = GeneratorState.create(g_cfg, cfg.seed).trees()
    on_cpu = step.sample(*cpu_trees, z2.cpu(), y2.cpu(), g_cfg)
    err = float((on_card - on_cpu).abs().max())
    print(f"sample f32 card vs cpu: max_abs_err {err:.3e} "
          f"(atol {SAMPLE_TOL})", flush=True)
    if not err <= SAMPLE_TOL:
        raise AssertionError(f"f32 sample on the card disagrees with the "
                             f"CPU path: {err}")
    return launches, clips


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dvdgan_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = check_k1(device)
    launches, _ = drive_sample(device)

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    kernels = [{
        "name": "convgru_seq (K1, bf16, sum of the 4 ucf101_64 levels)",
        "route": "cuda",
        "source": "dvdgan_tpu_torch/kernels/csrc/convgru_seq.cu",
        "replaces": "dvdgan_tpu/kernels/convgru_seq.py:104",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in bf16),
        "ms": sum(r["ms"] for r in bf16),
        "plain_ms": sum(r["plain_ms"] for r in bf16),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
