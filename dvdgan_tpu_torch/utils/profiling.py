"""Tracing, spans, counters and NaN debugging — the counterpart of
`dvdgan_tpu/utils/profiling.py`.

  * `trace(log_dir)`: torch.profiler around a block (with CUDA activity
    where a card is present); on exit the device is synchronized and one
    Chrome-format trace is written into log_dir, under the name
    TensorBoard's PyTorch profiler plugin reads (`*.pt.trace.json`).
    `start_trace`/`stop_trace` are its two halves, for a window that spans
    loop iterations (the trainer's `--profile`, `train/trainer.py`);
  * `span(name)`: the program's one span mechanism. Off (the default) it
    returns one shared null context and launches nothing. On
    (`enable(True)`) it is a range named `dvdgan.<name>` in torch.profiler's
    trace (`record_function`, on the profiler's clock, the device trace's)
    and an NVTX range on CUDA; and while the current stream is being
    captured into a CUDA graph it also launches a marker kernel where it
    begins and where it ends (`dvdgan_span_mark`,
    `kernels/csrc/span_mark.cu`), which the capture takes in with the work.
    A graph's replays run no host code, so only the markers carry a span's
    bounds onto the device timeline: a profiler ties every replayed kernel
    to the one graph launch. `recording_marks()` collects, in launch order,
    the (span, "B" | "E") each marker of a capture stands for, so that a
    reader pairs the i-th marker of a replay with the i-th entry
    (`train/step.py:MultiStep.marks`);
  * `graph_nodes(graph)`: the nodes of a captured graph
    (`torch.cuda.CUDAGraph(keep_graph=True)`) by type, counted through the
    CUDA driver's graph API. A replay runs each kernel node as one kernel,
    each memcpy node as one too (`memcpy32_post` in a trace) and each
    memset node as a fill or a kernel;
  * `COUNTERS`: the program's host-side counters, process-wide and always
    on, each one `time.perf_counter()` pair a count: the trainer's wait for
    its next batch, the sampler's host time a call (its first call apart),
    and the kernel nodes a
    step of the K-step graph captured last in the process (a copy of that
    `MultiStep.kernel_nodes`, kept here for a reader that holds no
    `MultiStep`);
  * `nan_check_mode()`: `jax_debug_nans`'s contract — raises
    `FloatingPointError` at the first op whose floating output holds a NaN,
    naming the op, in the forward and, through autograd's anomaly mode
    (which also names the forward op of the backward that failed), in the
    backward; both are restored on exit. Every op reads its output back
    to the host: a debugging mode, not a training one;
  * `anomaly_mode(on)`: autograd's anomaly mode for a block, restored on
    exit (the trainer's `--nan_check`).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import os
import socket
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose output is memory not yet written (a NaN there is no result)
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


def start_trace(device=None) -> torch.profiler.profile:
    """A started torch.profiler session: CPU activity, and CUDA where
    `device` (default: any card present) is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile
    on_cuda = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    acts = [ProfilerActivity.CPU]
    if on_cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, path: str, device=None) -> str:
    """Stops `prof` after the device's queued work and writes its Chrome
    trace to `path`; -> path."""
    if torch.cuda.is_available() and (
            device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profiles the block; -> the profile, whose trace is in log_dir after
    the block (`<host>_<pid>.<ms>.pt.trace.json`)."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        name = (f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns() // 1_000_000}.pt.trace.json")
        stop_trace(prof, os.path.join(log_dir, name), device)


PREFIX = "dvdgan."     # every span's name in a trace starts with it
_NULL = contextlib.nullcontext()
_enabled = False
_marks: Optional[list[tuple[str, str]]] = None   # the capture's, in order


def enable(on: bool = True) -> None:
    """Spans on or off for the whole process (off at import)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class _Span:
    """An open span: its NVTX range, its `record_function` range and, under
    a capture, its two markers."""

    def __init__(self, name: str):
        self.name = name
        self.cuda = torch.cuda.is_available()
        self.rf = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        if self.cuda:
            torch.cuda.nvtx.range_push(PREFIX + self.name)
        self.rf.__enter__()
        self._mark("B")
        return self

    def __exit__(self, *exc):
        self._mark("E")
        self.rf.__exit__(*exc)
        if self.cuda:
            torch.cuda.nvtx.range_pop()
        return False

    def _mark(self, kind: str) -> None:
        if not _capturing():
            return
        n = -1
        if _marks is not None:
            n = len(_marks)
            _marks.append((self.name, kind))
        _launch_mark(n)


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def span(name: str):
    """The block as the span `name` (module docstring); off: a shared null
    context."""
    if not _enabled:
        return _NULL
    return _Span(name)


@functools.cache
def _mark_lib() -> ctypes.CDLL:
    from dvdgan_tpu_torch.kernels import _build
    lib = _build.load("span_mark")
    lib.dvdgan_span_mark_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    lib.dvdgan_span_mark_launch.restype = ctypes.c_int
    lib.dvdgan_span_mark_error_string.argtypes = [ctypes.c_int]
    lib.dvdgan_span_mark_error_string.restype = ctypes.c_char_p
    return lib


def _launch_mark(n: int) -> None:
    """One marker on the current CUDA stream; n: its place in the marks."""
    lib = _mark_lib()
    err = lib.dvdgan_span_mark_launch(
        torch.cuda.current_device(), n,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"span marker launch failed: "
                           f"{lib.dvdgan_span_mark_error_string(err).decode()}"
                           f" ({err})")


@contextlib.contextmanager
def recording_marks():
    """-> the list that collects what each marker launched in the block
    stands for: (span name, "B" or "E"), in launch order. With spans on and
    a card present, the marker is built and launched once first, on the
    current stream, so that no capture inside the block loads a module."""
    global _marks
    if _enabled and torch.cuda.is_available():
        _launch_mark(-1)
    outer, _marks = _marks, []
    try:
        yield _marks
    finally:
        _marks = outer


@functools.cache
def _driver() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    return lib


NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}   # CUgraphNodeType


def graph_nodes(graph: torch.cuda.CUDAGraph) -> dict[str, int]:
    """The nodes of a captured graph made with `keep_graph=True`, by type:
    kernel, memcpy, memset and other (`cuGraphGetNodes`,
    `cuGraphNodeGetType`; the driver's API takes the runtime's
    cudaGraph_t as it is)."""
    lib, raw = _driver(), ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(0)
    counts = dict.fromkeys([*NODE_TYPES.values(), "other"], 0)
    for node in nodes:
        if lib.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        counts[NODE_TYPES.get(kind.value, "other")] += 1
    return counts


@dataclasses.dataclass
class Counters:
    """The program's host-side counters (module docstring)."""
    loader_wait_s: float = 0.0      # `Trainer.train` in `pending.result()`
    loader_wait_steps: int = 0      # the steps those waits fed
    # `train/step.py:sample`, call to return: the process's first call
    # (the kernels' build, cuDNN's plans), then every later one
    sample_first_s: Optional[float] = None
    sample_issue_s: float = 0.0
    sample_calls: int = 0
    # the kernel nodes a step of the last K-step graph captured, less the
    # span markers (`MultiStep.kernel_nodes`)
    kernel_nodes: Optional[float] = None

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


COUNTERS = Counters()


@contextlib.contextmanager
def anomaly_mode(on: bool = True):
    """Autograd's anomaly mode (with its NaN check) on for the block where
    `on` or already on; the previous setting is restored on exit."""
    before = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(before or on)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(before)


class _NaNCheck(TorchDispatchMode):
    """Raises at the first op whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (nan_check_mode)")
        return out


@contextlib.contextmanager
def nan_check_mode():
    with anomaly_mode(True), _NaNCheck():
        yield
