"""Entry "train": the program's trainer (`Trainer.train`) on the cell's
configuration, fed the benchmark's clips and weights.

Set-up builds one trainer, hands it the weights made from the seed at
step `ema_start` (a run that has passed it: EMA decays from the first
step on) and a loader over the benchmark's clips, and runs its first call
of K steps (call 1: the CUDA graph's capture and one replay) and its
second (a replay, timed to size the window). The window is whole K-step calls
lasting about `--seconds` (`window`); with `--trace 1` a further
`train()` of `trace_calls` calls runs under the profiler. After the
window the trainer is freed and the plain reference follows call 1 in f32
from the same weights, clips and noise (`compare`).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from port_bench import common, compare, data, flops, trace
from port_bench.reference import model as ref

MODELS = compare.MODELS


def program_config(ctx: common.Ctx, seed: int):
    """The trainer's Config: the configuration's flags, the run's seed,
    no sample dumps, checkpoints or evaluations in the window."""
    from dvdgan_tpu_torch.utils.config import Config
    known = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in ctx.flags.items() if k in known}
    k = ctx.flags["steps_per_call"]
    kw.update(mode="train", dataset="synthetic", seed=seed,
              out_dir=str(ctx.tmp / "out"), device=str(ctx.device),
              total_step=k * 10 ** 6, log_step=k * ctx.mix["log_calls"],
              sample_step=0, model_save_step=0, eval_step=0)
    return Config(**kw)


def _host(tree) -> dict:
    """A flat f32 copy on the host of a tree of the program's state."""
    return {p: v.detach().to("cpu", torch.float32, copy=True)
            for p, v in data.flatten(tree).items()}


class _Spanned:
    """The trainer's K-step call inside a host span "bench.step", which
    also counts, on the device, the steps whose metrics are not finite."""

    def __init__(self, multi, bad: torch.Tensor):
        self._multi, self._bad = multi, bad

    def __call__(self, *args):
        with trace.span("step"):
            state, metrics = self._multi(*args)
        stacked = torch.stack([v.float() for v in metrics.values()])
        self._bad += (~torch.isfinite(stacked)).any(dim=0).sum()
        return state, metrics

    def __getattr__(self, name):
        return getattr(self._multi, name)


class TrainCell:
    def __init__(self, ctx: common.Ctx):
        from dvdgan_tpu_torch.train import trainer as trainer_mod
        self.ctx = ctx
        f = ctx.flags
        self.k, self.b = f["steps_per_call"], f["batch_size"]
        self.first = f["ema_start"]
        self.spec = ref.spec_from_flags(f)
        self.shape = flops.Shape.of(f)
        self.dtype = torch.bfloat16 if f["bf16"] else torch.float32
        self.tr = trainer_mod.Trainer(
            program_config(ctx, data.program_seed(ctx.seed)))
        self.multi = None
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        place = self.tr._place

        def spanned_place(batch):
            with trace.span("host_copy"):
                return place(batch)

        self.tr._place = spanned_place
        self.reseed(ctx.seed)

    def reseed(self, seed: int) -> None:
        """The weights, clips and noise of `seed`, from step `first`."""
        from dvdgan_tpu_torch.data import Loader
        f = self.ctx.flags
        self.seed = seed
        st = data.make_state(self.spec, seed, self.ctx.device)
        st["step"] = self.first
        self.tr.state = data.to_program(st)
        self.tr.start_step = self.first
        self.tr.cfg.seed = data.program_seed(seed)
        if self.multi is not None:
            self.multi.seed = data.program_seed(seed)
        self.clips = data.ClipSet(self.ctx.mix["items"], f["n_frames"],
                                  f["img_size"], f["n_classes"], seed)
        self.tr.loader.close()
        self.tr.dataset = self.clips
        self.tr.loader = Loader(self.clips, self.b,
                                seed=data.loader_seed(seed),
                                num_threads=self.tr.cfg.loader_threads,
                                prefetch=self.tr.cfg.prefetch)

    def sync(self) -> None:
        if self.ctx.on_card:
            torch.cuda.synchronize()

    def run_to(self, step: int) -> None:
        with trace.span("train"):
            self.tr.train(total_step=step)

    def window(self, seconds: float, warm_s: float) -> tuple[int, float]:
        """Whole K-step calls for about `seconds`: one train() of as many
        calls as the warm call's time (which carries a train()'s start)
        says fit, then one of the calls its own rate says are left.
        -> (steps, seconds), all the work over all the time."""
        steps, secs = self.timed_calls(max(1, int(seconds / warm_s)))
        left = round((seconds - secs) * steps / (secs * self.k))
        if left > 0:
            more, more_s = self.timed_calls(left)
            steps, secs = steps + more, secs + more_s
        return steps, secs

    def call1(self) -> dict:
        """Call 1; -> what it left, on the host: Adam's counts, the
        params and EMA, G's running moments, and for the look behind the
        limits each step's losses and Adam's second moments."""
        self.run_to(self.first + self.k)
        if self.multi is None:
            self.multi = self.tr._multi
            self.tr._multi = _Spanned(self.multi, self.bad)
        st = self.tr.state
        return {"count": {m: int(st[m]["opt"]["count"]) for m in MODELS},
                "end": {**{m: _host(st[m]["params"]) for m in MODELS},
                        "g_ema": _host(st["g_ema"])},
                "stats": _host(st["g"]["stats"]),
                "nu": {m: _host(st[m]["opt"]["nu"]) for m in MODELS},
                "losses": {n: self.multi.metrics[n].float().cpu().tolist()
                           for n in compare.METRICS}}

    def timed_calls(self, n_calls: int) -> tuple[int, float]:
        """n_calls more K-step calls in one train(); -> (steps, seconds)."""
        self.sync()
        t0 = time.perf_counter()
        self.run_to(self.tr.start_step + n_calls * self.k)
        self.sync()
        return n_calls * self.k, time.perf_counter() - t0

    def drop_graph(self) -> None:
        """Frees the K-step call's CUDA graph and its pool; the next call
        captures again."""
        self.tr._multi = self.multi = None
        gc.collect()
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def free(self) -> None:
        self.tr.close()
        self.tr = self.multi = None
        gc.collect()
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def made(self) -> dict:
        """The params, EMA and running moments the benchmark made from
        the seed, on the device."""
        st = data.make_state(self.spec, self.seed, self.ctx.device)
        return {"end": {**{m: st[m]["params"] for m in MODELS},
                        "g_ema": st["g_ema"]},
                "stats": st["g"]["stats"]}

    def reference(self, seed: int, prec: str = "f32", fault=None) -> dict:
        """Call 1's K steps in the plain reference from the seed's
        weights; prec "f64" runs it in float64 (a witness of f32's own
        rounding for the look behind the limits), "fp8" is the control,
        "bf16" a witness of the program's rounding; `fault` one of
        `ref.FAULTS`."""
        dev = self.ctx.device
        dt = torch.float64 if prec == "f64" else torch.float32
        st = data.make_state(self.spec, seed, dev)
        st["step"] = self.first
        if dt == torch.float64:
            st = _cast(st, dt)
        losses = {n: [] for n in compare.METRICS}
        q = ref.Prec("f32" if prec == "f64" else prec)
        with ref.exact_f32():
            for j in range(self.first, self.first + self.k):
                real, y = data.batch(self.clips, data.batch_items(
                    self.ctx.mix["items"], self.b, seed, j))
                real = torch.from_numpy(real).to(dev, dt)
                y = torch.from_numpy(y).to(dev)
                draws = ref.step_draws(data.program_seed(seed), j,
                                       self.spec, self.b, self.dtype, dev)
                if dt == torch.float64:
                    draws = {"d_z": [z.double() for z in draws["d_z"]],
                             "d_idx": draws["d_idx"],
                             "g_z": draws["g_z"].double(),
                             "g_idx": draws["g_idx"]}
                st, metrics, _ = ref.train_step(st, real, y, draws,
                                                self.spec, q, fault)
                for n in compare.METRICS:
                    losses[n].append(float(metrics[n]))
                del real
        f32 = lambda t: {p: v.float() for p, v in t.items()}
        return {"losses": losses,
                "nu": {m: f32(st[m]["opt"]["nu"]) for m in MODELS},
                "stats": f32(st["g"]["stats"]),
                "end": {**{m: f32(st[m]["params"]) for m in MODELS},
                        "g_ema": f32(st["g_ema"])}}

    def numbers(self, prog: dict, ref_out: dict) -> dict[str, float]:
        """The compared numbers of call 1, on the device."""
        d = self.spec.d_steps
        return compare.train_numbers(
            {"g": self.k, "ds": self.k * d, "dt": self.k * d},
            on_device(prog, self.ctx.device), ref_out, self.made())


def _cast(st: dict, dt) -> dict:
    """A flat-dict train state with every float tensor in dtype dt."""
    if isinstance(st, dict):
        return {k: _cast(v, dt) for k, v in st.items()}
    if torch.is_tensor(st) and st.is_floating_point():
        return st.to(dt)
    return st


def on_device(prog: dict, dev) -> dict:
    """call1()'s tensors on the device."""
    to = lambda t: {p: v.to(dev) for p, v in t.items()}
    return {**prog, "end": {m: to(t) for m, t in prog["end"].items()},
            "stats": to(prog["stats"]),
            "nu": {m: to(t) for m, t in prog["nu"].items()}}


def run(ctx: common.Ctx) -> common.Outcome:
    mix = ctx.mix
    built = time.perf_counter()
    cell = TrainCell(ctx)
    made = time.perf_counter()
    prog = cell.call1()
    called = time.perf_counter()
    _, warm_s = cell.timed_calls(1)
    setup_s = time.perf_counter() - ctx.started
    phases = {"start and imports": built - ctx.started,
              "trainer and weights": made - built,
              "call 1": called - made,
              "of it the capture": cell.multi.capture_s
              if ctx.on_card else 0.0,
              "call 2": warm_s}
    cell.bad.zero_()
    steps, window_s = cell.window(ctx.seconds, warm_s)
    failed = int(cell.bad)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.on_card else None)
    e2e = {"train_clips_per_s": steps * cell.b / window_s,
           "setup_s": setup_s}
    if peak is not None:
        e2e["peak_mem_gib"] = peak / 2 ** 30
    readings = None
    notes = [f"window: {steps} steps (calls of {cell.k}) in "
             f"{window_s:.4f} s; set-up {setup_s:.4f} s: " + ", ".join(
                 f"{k} {v:.4f}" for k, v in phases.items())]
    if ctx.trace and ctx.on_card:
        n = mix["trace_calls"]
        first = cell.tr.start_step
        _, tl = trace.record(lambda: cell.run_to(first + n * cell.k))
        steps_fl = flops.train_step_flops(cell.shape, cell.b)
        readings = common.Readings(
            units_traced=n * cell.k, unit_s=window_s / steps,
            chips=ctx.chips, flops_per_unit=sum(steps_fl.values()),
            gru_bound_ms=flops.gru_bound_ms(
                cell.shape, cell.b, True, "bf16" if cell.dtype ==
                torch.bfloat16 else "f32"),
            timeline=tl)
        notes.append(f"model FLOPs a step by phase: {steps_fl}")
    cell.free()
    ref_out = cell.reference(ctx.seed)
    notes.append("call 1 losses, program | reference: " + "; ".join(
        f"{n} {prog['losses'][n]} | {ref_out['losses'][n]}"
        for n in compare.LOSSES))
    numbers = cell.numbers(prog, ref_out)
    return common.Outcome(e2e=e2e, attempted=steps, failed=failed,
                          numbers=numbers, memory_peak_bytes=peak,
                          readings=readings, notes=notes)
