"""The device's timeline from torch.profiler, reduced to what the per-layer
metrics read: each device operation's time by name, the device's busy time
and the traced window, and the idle gaps labelled by the benchmark's own
host spans (`span`, a `record_function` range named "bench.<what>").

The window is the extent of the device operations that start inside the
host span "bench.traced": from the first one's start to the last one's
end. Busy is the union of every kernel, copy and fill on the device in
it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "bench."
TRACED = "bench.traced"

# kernel families by name
GRU = re.compile(r"\b(conv3x3_mma_kernel|blocked_mma_kernel|"
                 r"blocked_step_kernel|gate_kernel|cand_kernel|"
                 r"cand_bwd_kernel|drh_kernel|dh_kernel)\b")
PORT = re.compile(r"\b(ups2x_\w*kernel|attn_\w*kernel|cell_\w*kernel|"
                  r"conv3x3_\w*kernel|blocked_\w*kernel)\b")
NCCL = re.compile(r"^nccl", re.I)
# cuDNN's and cuBLAS's convolutions and matrix products
LIBRARY = re.compile(r"gemm|gemv|xmma|cudnn|cutlass|nvjet|implicit_convolve|"
                     r"convolve_|conv2d_|_conv_|fprop|dgrad|wgrad|"
                     r"splitKreduce|^sm\d\d_|^ampere_|^hopper_|cublas",
                     re.I)


def family(name: str) -> str:
    """gru (K1, K2, K3), port (the other hand-written kernels), nccl,
    library (cuDNN and cuBLAS convolutions and GEMMs) or elementwise (the
    rest: PyTorch's elementwise, reduction, copy and layout kernels)."""
    if GRU.search(name):
        return "gru"
    if PORT.search(name):
        return "port"
    if NCCL.search(name):
        return "nccl"
    if LIBRARY.search(name):
        return "library"
    return "elementwise"


@dataclass
class Timeline:
    """The traced window on the device."""
    window_s: float
    busy_s: float
    kernel_s: dict[str, float] = field(default_factory=dict)   # by name
    copy_s: float = 0.0
    gaps: list[tuple[str, float]] = field(default_factory=list)
    n_ops: int = 0

    def family_s(self, fam: str) -> float:
        return sum(s for n, s in self.kernel_s.items() if family(n) == fam)

    def top_ops(self, n: int = 10) -> list[list]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in ops]

    def top_gaps(self, n: int = 10) -> list[list]:
        """The idle time by what the host was doing, the largest first."""
        by: dict[str, float] = {}
        for label, s in self.gaps:
            by[label] = by.get(label, 0.0) + s
        return [[label, s] for label, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, which a trace records."""
    import torch
    with torch.profiler.record_function(SPAN + name):
        yield


def record(fn):
    """fn() under torch.profiler (CPU and CUDA) inside the span
    "bench.traced"; -> (fn's value, the Timeline)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(TRACED):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return out, reduce(events)


def reduce(events: list[dict]) -> Timeline:
    """The Timeline of a Chrome trace's events (µs)."""
    spans, dev = [], []
    traced = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e.get("dur", 0.0)),
                        e.get("name", ""), cat))
        elif cat == "user_annotation" and e.get("name", "").startswith(SPAN):
            s = (float(e["ts"]), float(e.get("dur", 0.0)), e["name"])
            if e["name"] == TRACED:
                traced = s
            else:
                spans.append(s)
    if traced is None:
        raise RuntimeError("the trace holds no bench.traced span")
    t0, t1 = traced[0], traced[0] + traced[1]
    dev = sorted(d for d in dev if t0 <= d[0] <= t1)
    if not dev:
        return Timeline(window_s=0.0, busy_s=0.0)
    start = dev[0][0]
    end = max(ts + dur for ts, dur, _, _ in dev)
    kernel_s: dict[str, float] = {}
    copy_us = 0.0
    busy_us, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][0]
    for ts, dur, name, cat in dev:
        if cat == "kernel":
            kernel_s[name] = kernel_s.get(name, 0.0) + dur / 1e6
        else:
            copy_us += dur
        if ts > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, ts))
            cur_s = ts
        cur_e = max(cur_e, ts + dur)
    busy_us += cur_e - cur_s
    labelled = [(_label(spans, (a + b) / 2), (b - a) / 1e6) for a, b in gaps]
    return Timeline(window_s=(end - start) / 1e6, busy_s=busy_us / 1e6,
                    kernel_s=kernel_s, copy_s=copy_us / 1e6, gaps=labelled,
                    n_ops=len(dev))


def _label(spans, t: float) -> str:
    """The benchmark's spans open on the host at time t, innermost first,
    joined by '+'; "none" where the host was outside all of them."""
    open_ = sorted((dur, name) for ts, dur, name in spans
                   if ts <= t <= ts + dur)
    names = []
    for _, name in open_:
        short = name[len(SPAN):]
        if short not in names:
            names.append(short)
    return "+".join(names) if names else "none"
