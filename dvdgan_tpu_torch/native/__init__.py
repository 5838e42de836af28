"""Native (C++) host runtime of the port: fused clip assembly for the input
pipeline — the counterpart of `dvdgan_tpu/native/__init__.py`, with its own
copy of `clipops.cpp`.

`libclipops-<digest>.so` is built from clipops.cpp with g++ -O3 at first
use into `build/native/` at the root of the checkout (git-ignored; the
digest covers the source and the flags, so an edited source is rebuilt),
written to a temporary name and renamed, so concurrent processes see all
of it or none; nothing is written into the package tree. It is bound with
ctypes. Where no compiler builds it, `clip_window` takes the numpy path,
the reference's own bit-identical contract for a host without one;
`available()` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).parent / "clipops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libclipops-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.clip_window_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),            # frames
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # T0, H, W
            ctypes.POINTER(ctypes.c_float),            # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # T, S, start
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # y0, x0, s
            ctypes.c_int,                              # n_threads
        ]
        lib.clip_window_f32.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the C++ library is built and loaded (else numpy runs)."""
    return _load() is not None


def clip_window_numpy(frames: np.ndarray, t: int, size: int,
                      start: int) -> np.ndarray:
    """The numpy path of `clip_window` (the reference's, unchanged)."""
    t0, h, w, _ = frames.shape
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    sel = (start + np.arange(t)) % t0
    clip = frames[sel, y0:y0 + s, x0:x0 + s].astype(np.float32) / 255.0
    idx = np.minimum((np.arange(size) * s) // size, s - 1)
    clip = clip[:, idx][:, :, idx]
    return 2.0 * clip - 1.0


def clip_window(frames: np.ndarray, t: int, size: int, start: int,
                n_threads: int = 0) -> np.ndarray:
    """uint8 (T0, H, W, 3) -> float32 (t, size, size, 3) in [-1, 1]:
    window at `start` (wrapping), center-crop, nearest-resize, normalize.
    Uses the native kernel when available, numpy otherwise."""
    t0, h, w, c = frames.shape
    if c != 3 or frames.dtype != np.uint8:
        raise ValueError(f"clip_window takes uint8 (T0, H, W, 3) frames, "
                         f"not {frames.dtype} {frames.shape}")
    lib = _load()
    if lib is None:
        return clip_window_numpy(frames, t, size, start)
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    frames = np.ascontiguousarray(frames)
    out = np.empty((t, size, size, 3), np.float32)
    lib.clip_window_f32(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t0, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, size, start, y0, x0, s, n_threads)
    return out
