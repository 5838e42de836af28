"""Tracing, timing and NaN debugging — the counterpart of
`dvdgan_tpu/utils/profiling.py`.

  * `trace(log_dir)`: torch.profiler around a block (with CUDA activity
    where a card is present); on exit the device is synchronized and one
    Chrome-format trace is written into log_dir, under the name
    TensorBoard's PyTorch profiler plugin reads (`*.pt.trace.json`).
    `start_trace`/`stop_trace` are its two halves, for a window that spans
    loop iterations (the trainer's `--profile`, `train/trainer.py`);
  * `scope(name)`: a named range in the trace
    (`torch.profiler.record_function`), and an NVTX range on CUDA;
  * `nan_check_mode()`: `jax_debug_nans`'s contract — raises
    `FloatingPointError` at the first op whose floating output holds a NaN,
    naming the op, in the forward and, through autograd's anomaly mode
    (which also names the forward op of the backward that failed), in the
    backward; both are restored on exit. Every op reads its output back
    to the host: a debugging mode, not a training one;
  * `anomaly_mode(on)`: autograd's anomaly mode for a block, restored on
    exit (the trainer's `--nan_check`);
  * `timed(fn, *args, sync=True)`: (result, seconds), synchronizing the
    devices of the result's CUDA tensors before the clock is read;
  * `steps_per_sec(step_fn, state, *args, iters, warmup)`.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

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


@contextlib.contextmanager
def scope(name: str):
    """A named range around the block: in torch.profiler's trace, and as
    an NVTX range where a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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


def _sync(tree) -> None:
    devices = {t.device for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def timed(fn, *args, sync: bool = True, **kwargs):
    """-> (result, seconds). With `sync`, waits for the result's devices
    before reading the clock (a CUDA call returns before its work ends)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        _sync(out)
    return out, time.perf_counter() - t0


def steps_per_sec(step_fn, state, *args, iters: int = 10, warmup: int = 2
                  ) -> tuple[float, object]:
    """Rate of a `state, aux = step_fn(state, *args)`-shaped function over
    `iters` calls after `warmup`, synchronized at both ends; -> (steps/s,
    the final state)."""
    aux = None
    for _ in range(warmup):
        state, aux = step_fn(state, *args)
    _sync((state, aux))
    t0 = time.perf_counter()
    for _ in range(iters):
        state, aux = step_fn(state, *args)
    _sync((state, aux))
    return iters / (time.perf_counter() - t0), state
