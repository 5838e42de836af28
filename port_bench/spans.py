"""The program's own spans in a torch.profiler trace: device time by span of
`dvdgan_tpu_torch` (`utils/profiling.py:span`, ranges named
"dvdgan.<name>") and the device's idle gaps labelled by them.

A device operation (kernel, copy or fill) goes to the innermost program
span open where it was issued, named by the path of the spans open there,
outermost first ("step.d/adam"; "none" outside every span):

  * inside a CUDA graph's replay, by the span markers the capture took in
    (kernels named `dvdgan_span_mark`): the i-th marker of the trace stands
    for entry i mod len(marks) of the capture's list (`MultiStep.marks`:
    (span, "B" | "E") in launch order), and an operation on the markers'
    stream that starts between two markers of one replay belongs to the
    spans open after the first of them. The replay's host code ran at
    capture, so no host range can say this;
  * else by its `correlation` with the launch on the host (the runtime
    call of the same correlation): the spans open on the launching thread
    when it launched. A replayed kernel outside every marked span takes
    the spans around the graph's launch.

The markers' own time goes to "span marks". The window is that of
`trace.reduce`: the device operations that start inside "bench.traced"
(all of them where the trace has no such span).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from port_bench.trace import DEVICE_CATS, TRACED, family

PREFIX = "dvdgan."
MARK_KERNEL = "dvdgan_span_mark"
MARKS = "span marks"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the spans a train step's phases leave out: SN, Adam, EMA
NESTED = ("sn", "adam", "ema")


@dataclass
class Phases:
    device_s: dict[str, float] = field(default_factory=dict)   # by path
    gaps: list[tuple[str, float]] = field(default_factory=list)
    # by path, the kernels' seconds by family (`trace.family`)
    family_s: dict[str, dict[str, float]] = field(default_factory=dict)

    def seconds(self, keep) -> float:
        """Device seconds of the paths (split on "/") `keep` takes."""
        return sum(s for p, s in self.device_s.items() if keep(p.split("/")))


def _stream(e: dict):
    return e.get("args", {}).get("stream", e.get("tid"))


def reduce(events: list[dict], marks: list[tuple[str, str]] = ()
           ) -> Phases:
    """The program spans' device seconds and labelled idle gaps of a
    Chrome trace's events (µs); `marks`: the capture's list, for a trace
    of graph replays."""
    dev, launches, spans = [], {}, []
    traced = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        args = e.get("args", {})
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, dur, name, _stream(e), args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (ts, e.get("tid"))
        elif cat == "user_annotation" and name == TRACED:
            traced = (ts, ts + dur)
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((ts, ts + dur, e.get("tid"), name[len(PREFIX):]))
    if traced is not None:
        dev = [d for d in dev if traced[0] <= d[0] <= traced[1]]
    dev.sort(key=lambda d: d[0])
    spans.sort(key=lambda s: (s[0], -s[1]))
    graph = _marked(dev, marks)
    out = Phases()
    for ts, dur, name, stream, corr in dev:
        if name == MARK_KERNEL:
            path = MARKS
        else:
            path = graph(ts, stream)
            if path is None:
                at = launches.get(corr)
                path = _host_path(spans, *at) if at else "none"
        out.device_s[path] = out.device_s.get(path, 0.0) + dur / 1e6
        fam = out.family_s.setdefault(path, {})
        kind = family(name) if name != MARK_KERNEL else "marks"
        fam[kind] = fam.get(kind, 0.0) + dur / 1e6
    out.gaps = _gaps(dev, spans)
    return out


def _marked(dev, marks):
    """-> path(ts, stream): the marked spans open at ts on the markers'
    stream inside a replay, or None."""
    mk = [(ts, stream) for ts, _, name, stream, _ in dev
          if name == MARK_KERNEL]
    if not mk or not marks:
        return lambda ts, stream: None
    if len(mk) % len(marks):
        raise ValueError(f"{len(mk)} span markers in the trace for "
                         f"{len(marks)} a replay: the profiler missed some")
    times, paths, stack = [], [], []
    for i, (ts, _) in enumerate(mk):
        name, kind = marks[i % len(marks)]
        if kind == "B":
            stack.append(name)
        elif not stack or stack.pop() != name:
            raise ValueError(f"marker {i} ends {name!r}, which is not open")
        times.append(ts)
        paths.append("/".join(stack) or None)
    streams = {s for _, s in mk}

    def path(ts, stream):
        if stream not in streams:
            return None
        j = bisect.bisect_right(times, ts) - 1
        return paths[j] if j >= 0 else None
    return path


def _host_path(spans, ts: float, tid) -> str:
    """The program spans open on thread tid at ts, outermost first."""
    names = [n for s, e, t, n in spans if t == tid and s <= ts <= e]
    return "/".join(names) or "none"


def _gaps(dev, spans) -> list[tuple[str, float]]:
    """The device's idle gaps, each labelled by the path of the innermost
    program span open on the host at its middle ("none" outside all)."""
    out = []
    if not dev:
        return out
    end = dev[0][0]
    for ts, dur, *_ in dev:
        if ts > end:
            mid = (end + ts) / 2
            open_ = [(e - s, t) for s, e, t, _ in spans if s <= mid <= e]
            label = (_host_path(spans, mid, min(open_)[1]) if open_
                     else "none")
            out.append((label, (ts - end) / 1e6))
        end = max(end, ts + dur)
    return out


def train_split(p: Phases) -> dict[str, float]:
    """A train step's device seconds by phase: the three phases of
    `train_step` without the SN, Adam and EMA inside them, SN, the
    optimizer (Adam and EMA), and the rest (`other`: outside every phase,
    the span markers included)."""
    def phase(name):
        return lambda seg: name in seg and seg[-1] not in NESTED
    split = {"fakes": p.seconds(phase("step.fakes")),
             "d_update": p.seconds(phase("step.d")),
             "g_update": p.seconds(phase("step.g")),
             "sn": p.seconds(lambda seg: seg[-1] == "sn"),
             "optimizer": p.seconds(lambda seg: seg[-1] in ("adam", "ema"))}
    split["other"] = sum(p.device_s.values()) - sum(split.values())
    return split
