#!/usr/bin/env python3
"""Times builds of K4's cluster kernel (`csrc/convgru_cell.cu`) with -D
switches against each other in one process, bf16, at the one-launch planes
of the driven presets, with clusters of 8 and 16: for each shape and
cluster size one JSON line with each build's µs per launch (launches back
to back, `chip_smoke.launches_ms`) and whether its output has the default
build's bits; then K1's gate + candidate pair at the shape.

    python3 tools/torch_k4_variants.py [TAG=FLAGS ...]

Without arguments: the default build, the stage counts 2, 4 and 6
(`-DK4_STAGES`), and the two halves of a launch apart: `-DK4_DIAG=1` (no
mma) and `-DK4_DIAG=2` (no weight copies; its outputs are wrong and
reported so). The builds go to a temporary directory. One GPU.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (imports no part of the port)

DEFAULT = {"default": "", "stages2": "-DK4_STAGES=2",
           "stages4": "-DK4_STAGES=4", "stages6": "-DK4_STAGES=6",
           "no_mma": "-DK4_DIAG=1", "no_weight_copies": "-DK4_DIAG=2"}
SHAPES = [(chip_smoke.B, h, w, c) for h, w, c in chip_smoke.LEVELS[:2]] + [
    (chip_smoke.LONG_B, h, w, c) for h, w, c in chip_smoke.LONG_LEVELS[:2]]


def build(variants: dict[str, str], out_dir: str) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    from dvdgan_tpu_torch.kernels import _build
    src = str(_build.CSRC / "convgru_cell.cu")
    procs = {}
    for tag, flags in variants.items():
        so = os.path.join(out_dir, f"libk4_{tag}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags.split(), "-o", so,
               src]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs = {}
    for tag, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log[-3000:]}")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib = ctypes.CDLL(so)
        lib.convgru_cell_cluster_step.argtypes = [i, p, p, i64, i64, p, i64,
                                                  i64, p, p, p, i, i, i, i, i,
                                                  p]
        lib.convgru_cell_cluster_step.restype = i
        libs[tag] = lib
    return libs


def main() -> int:
    import torch

    from dvdgan_tpu_torch.kernels import convgru_cell as k4
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    if not torch.cuda.is_available():
        print("torch_k4_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = (dict(a.split("=", 1) for a in sys.argv[1:]) if sys.argv[1:]
                else DEFAULT)
    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, tmp)
        for b, h, w, c in SHAPES:
            gx, cx, h0, wg, wc = chip_smoke.k1_inputs(
                h, w, c, torch.bfloat16, dev, seed=0, b=b, t=1)
            gx_b, gx_pix = k1._pixel_strides(gx, "gx")
            cx_b, cx_pix = k1._pixel_strides(cx, "cx")
            stream = torch.cuda.current_stream(dev).cuda_stream
            for k in (8, 16):
                if k4.cluster_tiles(h, w, c, k) is None:
                    continue
                row, ref = {"shape": [b, h, w, c], "cluster": k}, None
                for tag, lib in libs.items():
                    out = torch.zeros_like(h0)
                    call = functools.partial(
                        lib.convgru_cell_cluster_step, dev.index or 0,
                        h0.data_ptr(), gx[0].data_ptr(), gx_b, gx_pix,
                        cx[0].data_ptr(), cx_b, cx_pix, wg.data_ptr(),
                        wc.data_ptr(), out.data_ptr(), b, h, w, c, k, stream)

                    def launch(call=call):
                        err = call()
                        if err:
                            raise RuntimeError(f"launch failed ({err})")
                    try:
                        launch()
                    except RuntimeError as e:
                        row[tag] = str(e)
                        continue
                    torch.cuda.synchronize()
                    ref = out.clone() if ref is None else ref
                    row[tag] = {"us": chip_smoke.launches_ms(launch) * 1e3,
                                "default_bits": torch.equal(out, ref)}
                print("k4_variant", json.dumps(row), flush=True)
            pair = chip_smoke.launches_ms(
                chip_smoke.k1_pair_launches((gx, cx, h0, wg, wc)))
            print("k4_variant", json.dumps({"shape": [b, h, w, c],
                                            "k1_pair_us": pair * 1e3}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
