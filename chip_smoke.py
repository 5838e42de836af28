#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dvdgan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one GPU

1. prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the port from csrc/ with nvcc (one process per source, all
   started together);
2. holds K1 against its plain PyTorch version at the shapes EMA-G sampling
   gives it (the four ucf101_64 GRU levels, T=16, B=16), in f32 with TF32
   off (atol 1e-4) and in bf16 (atol 3e-2), and times both (CUDA events,
   median of 10 runs after warm-up);
3. drives the sample entry (`python -m dvdgan_tpu_torch --mode sample
   --preset ucf101_64 --n_samples 16 --bf16 1`) with the launch counters
   zeroed just before, checks the clip (shape, finite, in [-1, 1]) and that
   every kernel of the path launched, then times sampling in clips/s and
   holds a small f32 sample on the card against the CPU (plain) path;
4. holds K2 against its plain version at the shapes the flagship train
   step's G update gives it (the four levels, T=16, B=8), in f32 with TF32
   off (atol 1e-4 × max|ref| per output) and in bf16 (5e-2 × max|ref|),
   timed beside its plain version and the plain autograd backward through
   K1's plain version;
5. drives the train entry (`python -m dvdgan_tpu_torch --mode train
   --preset ucf101_64 --dataset synthetic --batch_size 8 --bf16 1
   --total_step 5`) in a child
   process, whose launch counters start at 0 and which prints each step's
   launches: checks the losses are finite, that G/DS/DT params, the three
   SN u trees and G's BN stats moved, and that each step launched K1
   2·levels·T·2 times and K2 levels·T·4 times; then times train steps/s in
   bf16 (median of 7 after 2 warm-ups) and reads the device idle share and
   the time by kernel from torch.profiler;
6. holds one f32 train step at the flagship widths, batch 2, on the card
   against the CPU from the same state and draws (losses atol 1e-3; Adam
   mu, the gradient, within 1e-3 × max|mu| of each model);
7. prints one JSON line of the kernels, then the result line.

Any failing phase raises, so the script exits non-zero without the result
line; so does a machine without a CUDA device. Imports nothing of JAX or
of the JAX package (the train CLI's child process reads the reference's
numpy-only synthetic clips, `dvdgan_tpu.data`).
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
B_TRAIN = 8         # the flagship train batch: K2 runs at the G update's
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2, relative to max|ref| of each output: bf16 roundings of rh, da and the
# dh carry flip with the summation order and compound over 16 steps
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SAMPLE_TOL = 2e-3   # f32 clip, card vs CPU: cuDNN vs CPU conv sum order
TRAIN_STEPS = 5
REPO = os.path.dirname(os.path.abspath(__file__))


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


def k1_inputs(h: int, w: int, c: int, dtype, device, seed: int, b: int = B):
    g = torch.Generator().manual_seed(seed)
    scale = (9 * c) ** -0.5          # unit-gain 3×3 convs, as SN leaves them

    def rand(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g)).to(device, dtype)

    return (rand(T, b, h, w, 2 * c), rand(T, b, h, w, c),
            torch.tanh(rand(b, h, w, c)).contiguous(),
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


def check_k2(device) -> list[dict]:
    from dvdgan_tpu_torch.kernels import convgru_bwd as k2
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    names = ("dgx", "dcx", "dh0", "dwg", "dwc")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (h, w, c) in enumerate(LEVELS):
            args = k1_inputs(h, w, c, dtype, device, seed=10 + i, b=B_TRAIN)
            hs = k1.gru_sequence_fused(*args)
            g = torch.randn(hs.shape, generator=torch.Generator().manual_seed(
                20 + i)).to(device, dtype)
            ref = k2.gru_sequence_bwd_reference(*args, hs, g)
            out = k2.gru_sequence_bwd(*args, hs, g)
            torch.cuda.synchronize()
            errs = {n: float((o.float() - r.float()).abs().max())
                    for n, o, r in zip(names, out, ref)}
            scales = {n: float(r.float().abs().max())
                      for n, r in zip(names, ref)}
            # the plain autograd backward through K1's plain version
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            hs_plain = k1.gru_sequence_reference(*leaves)
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [T, B_TRAIN, h, w, c],
                   "max_abs_err": max(errs.values()),
                   "max_rel_err": max(errs[n] / scales[n] for n in names),
                   "ms": cuda_ms(lambda: k2.gru_sequence_bwd(*args, hs, g)),
                   "plain_ms": cuda_ms(
                       lambda: k2.gru_sequence_bwd_reference(*args, hs, g)),
                   "plain_autograd_ms": cuda_ms(lambda: torch.autograd.grad(
                       hs_plain, leaves, g, retain_graph=True))}
            del hs_plain, leaves
            print("K2 " + json.dumps(row), flush=True)
            bad = [n for n in names if not errs[n] <= K2_TOL[dtype] * scales[n]]
            if bad:
                raise AssertionError(
                    f"K2 disagrees with its plain version on {bad}: {errs} "
                    f"(atol {K2_TOL[dtype]} × {scales})")
            rows.append(row)
    return rows


def _tree_moved(before, after) -> tuple[int, int]:
    """(leaves that changed, leaves) of two flat {path: array} dicts."""
    moved = sum(not np.array_equal(before[k], after[k]) for k in before)
    return moved, len(before)


def drive_train() -> dict:
    """The train CLI in a child process; returns the run's K1 and K2
    launches and its wall seconds."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.kernels import convgru_bwd as k2
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.utils.config import parse_config

    # the preset reads frame folders; the port trains on the reference's
    # synthetic clips (the frames pipeline is not ported yet)
    argv = ["--mode", "train", "--preset", "ucf101_64", "--dataset",
            "synthetic", "--batch_size", str(B_TRAIN), "--bf16", "1",
            "--total_step", str(TRAIN_STEPS)]
    cfg = parse_config(argv)
    g_cfg = cfg.g_config()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dvdgan_tpu_torch", *argv, "--out_dir",
             tmp], cwd=REPO, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"train CLI exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        with np.load(os.path.join(tmp, "train_state.npz")) as f:
            after = {k: f[k] for k in f.files}
    steps = [dict(zip(ln.split()[2::2], ln.split()[3::2]))
             for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"{len(steps)} step lines, want {TRAIN_STEPS}")
    per_step = g_cfg.n_levels * g_cfg.n_frames
    want = {"k1_launches": 2 * per_step * k1.LAUNCHES_PER_STEP,
            "k2_launches": per_step * k2.LAUNCHES_PER_STEP}
    for s in steps:
        losses = [float(s[k]) for k in ("d_loss", "d_loss_s", "d_loss_t",
                                        "g_loss")]
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite loss in the train run: {s}")
        got = {k: int(s[k]) for k in want}
        if got != want:
            raise AssertionError(f"launches per train step {got}, want {want}")
    if int(after["step"]) != TRAIN_STEPS:
        raise AssertionError(f"final step {after['step']}")
    if not all(np.isfinite(v).all() for v in after.values()):
        raise AssertionError("non-finite values in the final train state")
    before = interop.train_state_to_flat(train_state.create(
        cfg.seed, g_cfg, cfg.ds_config(), cfg.dt_config()))
    moved = {}
    for prefix in ("g/params/", "ds/params/", "dt/params/", "g/sn_u/",
                   "ds/sn_u/", "dt/sn_u/", "g/stats/"):
        keys = [k for k in before if k.startswith(prefix)]
        moved[prefix] = _tree_moved({k: before[k] for k in keys},
                                    {k: after[k] for k in keys})
    print("train moved leaves " + json.dumps(moved), flush=True)
    for prefix, (n_moved, n) in moved.items():
        # every param tree moves almost whole; an SN u moves once its
        # (orthogonally initialised) kernel has left the orthogonal group
        least = 0.9 * n if "/params/" in prefix else 1
        if n_moved < least:
            raise AssertionError(f"{prefix}: {n_moved} of {n} leaves moved")
    return {"k1": TRAIN_STEPS * want["k1_launches"],
            "k2": TRAIN_STEPS * want["k2_launches"], "cli_s": secs}


class Replay:
    """Fixed draws (z by stream, frame indices by stream) on one device."""

    def __init__(self, zs: dict, ids: dict, device):
        self.zs, self.ids, self.device = zs, ids, device

    def z(self, i):
        return self.zs[i].to(self.device)

    def idx(self, i):
        return self.ids[i].to(self.device)


def flagship(batch: int):
    from dvdgan_tpu_torch.utils.config import parse_config
    cfg = parse_config(["--preset", "ucf101_64", "--batch_size", str(batch)])
    return (cfg.seed, cfg.g_config(), cfg.ds_config(), cfg.dt_config(),
            cfg.train_config())


def time_train(device) -> dict:
    """bf16 flagship train steps/s (batch 8), and the profiler's view."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.train import step

    seed, g_cfg, ds_cfg, dt_cfg, tc = flagship(B_TRAIN)
    state = train_state.to_device(
        train_state.create(seed, g_cfg, ds_cfg, dt_cfg), device)
    gen = torch.Generator(device).manual_seed(seed)
    real = torch.tanh(torch.randn(B_TRAIN, g_cfg.n_frames, g_cfg.img_size,
                                  g_cfg.img_size, 3, generator=gen,
                                  device=device)).to(torch.bfloat16)
    y = torch.randint(0, g_cfg.n_classes, (B_TRAIN,), generator=gen,
                      device=device)
    draws = step.TorchDraws(gen, B_TRAIN, g_cfg.z_dim, g_cfg.n_frames,
                            ds_cfg.k_frames, torch.bfloat16)

    def one():
        nonlocal state
        state, metrics = step.train_step(state, real, y, draws, g_cfg,
                                         ds_cfg, dt_cfg, tc)
        return metrics

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    secs = []
    for _ in range(7):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = statistics.median(secs)

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only: a host op's self device time repeats its
    # kernels', and kernels launched through ctypes land on the enclosing
    # autograd Function's range as well
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    out = {"batch": B_TRAIN, "dtype": "bfloat16",
           "ms_per_step": sec * 1e3, "steps_per_s": 1.0 / sec,
           "step_ms_all": [x * 1e3 for x in secs],
           "profiled_ms_per_step": wall_us / n_prof / 1e3,
           "device_busy_ms_per_step": busy_us / n_prof / 1e3,
           # against the unprofiled step (the profiler slows the host)
           "device_idle_share": 1.0 - busy_us / n_prof / 1e6 / sec,
           "device_idle_share_profiled": 1.0 - busy_us / wall_us,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    print("train_rate " + json.dumps(out), flush=True)
    for e in top:
        print(f"  device {dev_us(e) / n_prof / 1e3:9.3f} ms/step "
              f"x{e.count // n_prof:<5d} {e.key[:90]}", flush=True)
    return out


def check_train_f32(device) -> dict:
    """One f32 flagship-width step at batch 2, card against CPU."""
    from dvdgan_tpu_torch.core import tree
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.train import step

    b = 2
    seed, g_cfg, ds_cfg, dt_cfg, tc = flagship(b)
    gen = torch.Generator().manual_seed(seed + 1)
    real = torch.tanh(torch.randn(b, g_cfg.n_frames, g_cfg.img_size,
                                  g_cfg.img_size, 3, generator=gen))
    y = torch.randint(0, g_cfg.n_classes, (b,), generator=gen)
    draws = step.TorchDraws(gen, b, g_cfg.z_dim, g_cfg.n_frames,
                            ds_cfg.k_frames, torch.float32)
    n_streams = 3 * tc.d_steps + 2     # z at multiples of 3, indices between
    zs = {i: draws.z(i) for i in range(0, n_streams, 3)}
    ids = {i: draws.idx(i) for i in range(n_streams) if i % 3}
    state = train_state.create(seed, g_cfg, ds_cfg, dt_cfg)
    t0 = time.perf_counter()
    ref_state, ref_m = step.train_step(state, real, y, Replay(zs, ids, "cpu"),
                                       g_cfg, ds_cfg, dt_cfg, tc)
    cpu_s = time.perf_counter() - t0
    out_state, out_m = step.train_step(
        train_state.to_device(state, device), real.to(device), y.to(device),
        Replay(zs, ids, device), g_cfg, ds_cfg, dt_cfg, tc)
    loss_err = {k: abs(float(out_m[k]) - float(ref_m[k])) for k in ref_m}
    mu_err = {}
    for m in ("g", "ds", "dt"):
        ref_mu = tree.flatten_with_paths(ref_state[m]["opt"]["mu"])
        out_mu = tree.flatten_with_paths(out_state[m]["opt"]["mu"])
        scale = max(float(v.abs().max()) for v in ref_mu.values())
        mu_err[m] = max(float((out_mu[k].cpu() - v).abs().max())
                        for k, v in ref_mu.items()) / scale
    res = {"losses": {k: float(v) for k, v in ref_m.items()},
           "loss_abs_err": loss_err, "mu_err_over_max_mu": mu_err,
           "cpu_step_s": cpu_s}
    print("train f32 card vs cpu " + json.dumps(res), flush=True)
    if not max(loss_err.values()) <= 1e-3:
        raise AssertionError(f"f32 train losses, card vs CPU: {loss_err}")
    if not max(mu_err.values()) <= 1e-3:
        raise AssertionError(f"f32 gradients (Adam mu), card vs CPU: "
                             f"{mu_err}")
    return res


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
    rows_k2 = check_k2(device)
    train = drive_train()
    time_train(device)
    check_train_f32(device)

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    bf16_k2 = [r for r in rows_k2 if r["dtype"] == "bfloat16"]
    kernels = [{
        "name": "convgru_seq (K1, bf16, sum of the 4 ucf101_64 levels, B=16)",
        "route": "cuda",
        "source": "dvdgan_tpu_torch/kernels/csrc/convgru_seq.cu",
        "replaces": "dvdgan_tpu/kernels/convgru_seq.py:104",
        "launches": launches + train["k1"],
        "launches_by_path": {"sample": launches, "train": train["k1"]},
        "max_abs_err": max(r["max_abs_err"] for r in bf16),
        "ms": sum(r["ms"] for r in bf16),
        "plain_ms": sum(r["plain_ms"] for r in bf16),
    }, {
        "name": "convgru_bwd (K2, bf16, sum of the 4 ucf101_64 levels, B=8)",
        "route": "cuda",
        "source": "dvdgan_tpu_torch/kernels/csrc/convgru_bwd.cu",
        "replaces": "dvdgan_tpu/kernels/convgru_bwd.py:194",
        "launches": train["k2"],
        "launches_by_path": {"sample": 0, "train": train["k2"]},
        "max_abs_err": max(r["max_abs_err"] for r in bf16_k2),
        "ms": sum(r["ms"] for r in bf16_k2),
        "plain_ms": sum(r["plain_ms"] for r in bf16_k2),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
