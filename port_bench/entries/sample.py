"""Entry "sample": the program's sampler (`train/step.py:sample`) of EMA-G
in a closed loop, each batch's clips copied to the host before the next
batch is asked for.

Set-up makes G's weights, BN running moments and SN vectors from the seed
on the device and warms the sampler at the cell's batch. The window asks
for batches 0, 1, … (latents and labels drawn on the device from (seed,
batch)) until `--seconds` have passed; a batch's time runs from its inputs
being drawn until its clips are on the host. A few batches, drawn from the
seed among those the window surely reaches, are kept; after the window the
plain reference samples them again in f32 (`compare.clip_numbers`).
The clips are copied into one pinned host buffer, made in set-up, that
each batch overwrites; a kept batch is cloned out of it once its time is
taken.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from port_bench import common, compare, data, flops, trace
from port_bench.reference import model as ref

WARM_BASE = 1 << 40     # warm-up batches: indices the window never uses


class SampleCell:
    def __init__(self, ctx: common.Ctx):
        from dvdgan_tpu_torch.utils.config import Config
        self.ctx = ctx
        f = ctx.flags
        known = {fl.name for fl in dataclasses.fields(Config)}
        cfg = Config(**{k: v for k, v in f.items() if k in known})
        self.g_cfg = cfg.g_config()
        self.spec = ref.spec_from_flags(f)
        self.shape = flops.Shape.of(f)
        self.dtype = torch.bfloat16 if f["bf16"] else torch.float32
        self.b = ctx.mix["batch"]
        st = data.to_program(data.make_state(self.spec, ctx.seed, ctx.device,
                                             models=("g",)))
        self.g = (st["g_ema"], st["g"]["stats"], st["g"]["sn_u"])
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        shape = (self.b, self.g_cfg.n_frames, self.g_cfg.img_size,
                 self.g_cfg.img_size, 3)
        self.host = torch.empty(shape, dtype=self.dtype,
                                pin_memory=ctx.on_card)

    def one(self, i: int) -> tuple[torch.Tensor, float]:
        """Batch i: -> (its clips on the host, in the buffer the next
        batch overwrites; seconds from its inputs to its clips on the
        host)."""
        from dvdgan_tpu_torch.train import step as step_mod
        t0 = time.perf_counter()
        with trace.span("inputs"):
            z, y = data.sample_inputs(self.ctx.seed, i, self.b,
                                      self.spec.z_dim, self.spec.n_classes,
                                      self.dtype, self.ctx.device)
        with trace.span("sampler"):
            x = step_mod.sample(*self.g, z, y, self.g_cfg)
        self.bad += (~torch.isfinite(x)).flatten(1).any(dim=1).sum()
        with trace.span("host_copy"):
            self.host.copy_(x, non_blocking=True)
            if self.ctx.on_card:
                torch.cuda.current_stream(self.ctx.device).synchronize()
        return self.host, time.perf_counter() - t0

    def free(self) -> None:
        self.g = None
        gc.collect()
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def reference(self, seed: int, batches: list[int], prec: str = "f32"
                  ) -> dict[int, torch.Tensor]:
        """The plain reference's clips of the given batches."""
        dev = self.ctx.device
        st = data.make_state(self.spec, seed, dev, models=("g",))
        out = {}
        with ref.exact_f32():
            for i in batches:
                z, y = data.sample_inputs(seed, i, self.b, self.spec.z_dim,
                                          self.spec.n_classes, self.dtype,
                                          dev)
                out[i] = ref.sample(st["g_ema"], st["g"]["stats"],
                                    st["g"]["sn_u"], z.float(), y, self.spec,
                                    ref.Prec(prec))
        return out


def kept_batches(seed: int, reach: int, n: int) -> list[int]:
    """n batch indices below `reach`, drawn from the seed."""
    rng = np.random.RandomState(data.derive(seed, 5) % (1 << 32))
    reach = max(reach, 1)
    return sorted(int(i) for i in rng.choice(reach, size=min(n, reach),
                                              replace=False))


def run(ctx: common.Ctx) -> common.Outcome:
    mix = ctx.mix
    cell = SampleCell(ctx)
    warm = [cell.one(WARM_BASE + j)[1] for j in range(mix["warm_batches"])]
    setup_s = time.perf_counter() - ctx.started
    reach = int(ctx.seconds / max(warm[-1], 1e-3) * mix["keep_within"])
    keep = set(kept_batches(ctx.seed, reach, mix["check_batches"]))
    cell.bad.zero_()
    kept, times = {}, []
    t0 = time.perf_counter()
    i = 0
    while True:
        host, secs = cell.one(i)
        times.append(secs)
        if i in keep:
            kept[i] = host.clone()
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    failed = int(cell.bad)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.on_card else None)
    p95 = statistics.quantiles(times, n=100)[94] if len(times) > 1 else \
        times[0]
    e2e = {"sample_clips_per_s": i * cell.b / window_s,
           "sample_batch_ms_p95": p95 * 1e3, "setup_s": setup_s}
    if peak is not None:
        e2e["peak_mem_gib"] = peak / 2 ** 30
    notes = [f"window: {i} batches of {cell.b} in {window_s:.4f} s; "
             f"sample_batch_ms_p95 over {len(times)} batches; median "
             f"{statistics.median(times) * 1e3:.4f} ms; set-up "
             f"{setup_s:.4f} s; checked batches {sorted(keep)}"]
    readings = None
    if ctx.trace and ctx.on_card:
        n = mix["trace_batches"]
        _, tl = trace.record(lambda: [cell.one(i + j) for j in range(n)])
        readings = common.Readings(
            units_traced=n, unit_s=window_s / i,
            chips=ctx.chips, flops_per_unit=flops.sample_flops(cell.shape,
                                                               cell.b),
            gru_bound_ms=flops.gru_bound_ms(
                cell.shape, cell.b, False, "bf16" if cell.dtype ==
                torch.bfloat16 else "f32"),
            timeline=tl)
    cell.free()
    missing = keep - set(kept)
    refs = cell.reference(ctx.seed, sorted(kept))
    numbers = compare.clip_numbers(
        [(kept[j].to(ctx.device).float(), refs[j]) for j in sorted(kept)])
    if missing:
        notes.append(f"checked batches never served: {sorted(missing)}")
        numbers["clip_gap"] = float("inf")
    return common.Outcome(e2e=e2e, attempted=i * cell.b, failed=failed,
                          numbers=numbers, memory_peak_bytes=peak,
                          readings=readings, notes=notes)
