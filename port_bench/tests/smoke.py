"""A copy of the benchmark with cells at the program's `smoke` preset, for
the CPU tests: written into a temporary root beside BENCHMARK.json, found
by name like any cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SMOKE_FLAGS = {
    "img_size": 64, "n_frames": 8, "n_classes": 10, "ch": 16, "d_ch": 16,
    "z_dim": 120, "emb_dim": 120, "attn_res": 32, "k_frames": 4,
    "batch_size": 4, "d_steps": 2, "grad_accum": 2, "fake_gen": "pooled",
    "lr_g": 0.0001, "lr_d": 0.0005, "beta1": 0.0, "beta2": 0.999,
    "ema_decay": 0.9999, "ema_start": 1000, "remat": False, "bf16": False,
    "ups_fused": "off", "attn_fused": "off", "remat_save": "gru+ups",
    "steps_per_call": 2, "loader_threads": 2, "prefetch": 2}
# f32 on the CPU: the program's plain route against the reference differs
# by summation order alone
TRAIN_GAPS = ("stats_gap", "stats_worst", "change_g", "change_ds",
              "change_dt", "change_ema", "turn_g", "turn_ds", "turn_dt",
              "grad_g", "grad_ds", "grad_dt")
# EMA's steps, 1e-4 of a step of G, are a few ulps of each leaf: f32's
# rounding of them reads ~1e-3
SMOKE_LIMITS = {
    "smoke.train": {"call1_count": 0, "call1_unmoved": 0,
                    **dict.fromkeys(TRAIN_GAPS, 1e-3), "change_ema": 1e-2},
    "smoke.sample": {"clip_gap": 1e-3, "clip_rms_gap": 1e-3}}


def smoke_root(tmp: Path, limits_of: dict | None = None) -> Path:
    """tmp holding BENCHMARK.json and port_bench/ with the smoke cells
    added as files and entries. `limits_of` {smoke cell: cell}: take that
    cell's limits instead of the smoke cells' own."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "port_bench", tmp / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp / "port_bench"
    (pb / "configs" / "smoke.json").write_text(json.dumps({
        "source": "the smoke preset of dvdgan_tpu_torch/utils/config.py",
        "flags": SMOKE_FLAGS, "reduced": []}))
    for cell, lim in SMOKE_LIMITS.items():
        if limits_of and cell in limits_of:
            lim = json.loads((pb / "limits" / f"{limits_of[cell]}.json")
                             .read_text())["limits"]
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))
    (pb / "traffic" / "train_small.json").write_text(json.dumps({
        "entry": "train", "items": 64, "log_calls": 1, "trace_calls": 1}))
    (pb / "traffic" / "sample_small.json").write_text(json.dumps({
        "entry": "sample", "batch": 4, "warm_batches": 1,
        "check_batches": 2, "keep_within": 0.5, "trace_batches": 2}))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "smoke", "source": "smoke preset",
                             "file": "port_bench/configs/smoke.json",
                             "reduced": [], "why": "the CPU tests' size"})
    bench["workloads"] += [
        {"name": "smoke.train", "config": "smoke",
         "traffic": "train_small", "chips": 1, "why": "CPU test"},
        {"name": "smoke.sample", "config": "smoke",
         "traffic": "sample_small", "chips": 1, "why": "CPU test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads")
        if ws is None:
            continue
        if "ucf101_64.train" in ws:
            ws.append("smoke.train")
        if "ucf101_64.sample" in ws:
            ws.append("smoke.sample")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
