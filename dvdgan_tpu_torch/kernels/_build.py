"""Build the package's CUDA sources with nvcc at first use and load them
with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/lib<name>-<digest>.so` beside this file (the digest covers the source,
the shared headers `csrc/*.cuh` and the flags, so an edited source or header
is rebuilt). The build directory can be
moved with DVDGAN_TORCH_KERNEL_DIR. PyTorch's headers are not included, so
one source builds in seconds. `build()` starts one nvcc per source, all at
once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
SOURCES = ("convgru_seq", "convgru_bwd", "convgru_blocked", "convgru_cell",
           "ups2x_fused", "attention_spatial", "span_mark")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    return Path(os.environ.get("DVDGAN_TORCH_KERNEL_DIR",
                               Path(__file__).parent / "build"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is "
                           "needed to build the package's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source not yet built, one nvcc each, all started
    together. Returns {name: compiler output} (ptxas register and shared
    memory report) for the ones it compiled; raises if any fails."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
