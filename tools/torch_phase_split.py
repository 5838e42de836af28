#!/usr/bin/env python3
"""Where a benchmark cell's device time goes by the port's own spans, on the
card: the cell's set-up as `port_bench` makes it (weights, clips and noise
from the seed), an untraced window with spans off, then spans on
(`utils/profiling.py:enable`) and, for training, the K-step graph captured
again with its span markers by one untraced call; then a few calls or
batches under torch.profiler, reduced by `port_bench/spans.py`.

Prints one JSON line: the untraced window's time a unit (train step or
sampler batch) and, over it, the counters (`profiling.COUNTERS`: loader
wait ms a step, sampler host ms a batch, the graph's kernel nodes a step);
from the trace, the device ms a unit by program span path and by kernel
family within each, a train step's split (`spans.train_split`), the busy
time and window a unit (`trace.reduce`), the idle time a unit by program
span, and the graph's device operations the profiler saw a step (those of
a `cudaGraphLaunch`'s correlation) beside its nodes a step by type.

    python3 tools/torch_phase_split.py --workload ucf101_64.train \\
        --seed 7 --seconds 10
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def record(fn) -> list[dict]:
    """fn() under torch.profiler inside "bench.traced" (as
    `port_bench/trace.py:record`); -> the Chrome trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench import trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.TRACED):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


def reading(events, marks, units: int) -> dict:
    """The trace's program spans and timeline, a unit, in ms."""
    from port_bench import spans, trace
    tl = trace.reduce(events)
    p = spans.reduce(events, marks)
    per = lambda s: s * 1e3 / units
    idle: dict[str, float] = {}
    for label, s in p.gaps:
        idle[label] = idle.get(label, 0.0) + per(s)
    graph = {e["args"]["correlation"] for e in events
             if e.get("name") == "cudaGraphLaunch" and "args" in e}
    replayed = sum(1 for e in events if e.get("cat") in trace.DEVICE_CATS
                   and e.get("args", {}).get("correlation") in graph)
    return {"busy_ms": per(tl.busy_s), "window_ms": per(tl.window_s),
            "device_ms_by_span": {k: per(v) for k, v in
                                  sorted(p.device_s.items())},
            "family_ms_by_span": {k: {f: per(s) for f, s in v.items()}
                                  for k, v in sorted(p.family_s.items())},
            "split_ms": {k: per(v) for k, v in spans.train_split(p).items()},
            "idle_ms_by_span": dict(sorted(idle.items(),
                                           key=lambda kv: -kv[1])),
            "graph_ops_traced_per_unit": replayed / units}


def train(ctx, entry, seconds: float, calls: int) -> dict:
    from dvdgan_tpu_torch.utils import profiling
    cell = entry.TrainCell(ctx)
    cell.call1()
    _, warm_s = cell.timed_calls(1)
    c0 = profiling.COUNTERS.snapshot()
    steps, window_s = cell.window(seconds, warm_s)
    c1 = profiling.COUNTERS.snapshot()
    out = {"unit_ms": window_s * 1e3 / steps, "steps": steps,
           "kernel_nodes_off": c1["kernel_nodes"],
           "loader_wait_ms": _per(c0, c1, "loader_wait_s",
                                  "loader_wait_steps")}
    profiling.enable(True)
    cell.drop_graph()
    cell.timed_calls(1)             # the capture with markers, untraced
    multi = cell.tr._multi
    out["kernel_nodes_on"] = multi.kernel_nodes
    out["marks_a_replay"] = len(multi.marks)
    out["graph_nodes_per_unit"] = {t: n / cell.k
                                   for t, n in multi.nodes.items()}
    first = cell.tr.start_step
    events = record(lambda: cell.run_to(first + calls * cell.k))
    out.update(reading(events, multi.marks, calls * cell.k))
    profiling.enable(False)
    cell.free()
    return out


def sample(ctx, entry, seconds: float, batches: int) -> dict:
    from dvdgan_tpu_torch.utils import profiling
    cell = entry.SampleCell(ctx)
    for j in range(ctx.mix["warm_batches"]):
        cell.one(entry.WARM_BASE + j)
    c0 = profiling.COUNTERS.snapshot()
    t0, i = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        cell.one(i)
        i += 1
    window_s = time.perf_counter() - t0
    c1 = profiling.COUNTERS.snapshot()
    out = {"unit_ms": window_s * 1e3 / i, "batches": i,
           "sample_issue_ms": _per(c0, c1, "sample_issue_s",
                                   "sample_calls")}
    profiling.enable(True)
    events = record(lambda: [cell.one(i + j) for j in range(batches)])
    out.update(reading(events, [], batches))
    profiling.enable(False)
    cell.free()
    return out


def _per(c0: dict, c1: dict, secs: str, count: str):
    n = c1[count] - c0[count]
    return (c1[secs] - c0[secs]) * 1e3 / n if n else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--units", type=int, default=0,
                   help="traced K-step calls or batches (default: the "
                   "traffic's trace_calls or trace_batches)")
    args = p.parse_args(argv)
    import torch

    from port_bench import common, run, spec
    if not torch.cuda.is_available():
        print("torch_phase_split: needs a CUDA device", file=sys.stderr)
        return 3
    run.cache_env(REPO)
    bench = spec.load(REPO)
    cell = spec.cell(bench, args.workload)
    tmp = common.scratch()
    ctx = common.Ctx(
        cell=args.workload, chips=cell["chips"],
        config=spec.config(bench, REPO, cell["config"]),
        mix=spec.traffic(bench, REPO, cell["traffic"]),
        limits=spec.limits(bench, REPO, args.workload), seed=args.seed,
        seconds=args.seconds, trace=True, device=torch.device("cuda:0"),
        tmp=tmp, started=STARTED)
    entry = spec.entry(bench, REPO, ctx.mix["entry"])
    try:
        if ctx.mix["entry"] == "train":
            out = train(ctx, entry, args.seconds,
                        args.units or ctx.mix["trace_calls"])
        else:
            out = sample(ctx, entry, args.seconds,
                         args.units or ctx.mix["trace_batches"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), **out}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
