"""The readings a cell's limits are set from, in one process on the card:

  program      the program's numbers against the f32 reference, a seed
               each (the lower reading: the largest over a dozen seeds or
               more);
  control      the reference in the nearest precision below the
               configuration's (bf16 → fp8 e4m3 operands) in the
               program's place (the upper reading: the smallest over its
               seeds);
  <fault>      training: the reference with one of `reference.FAULTS`
               planted, in the program's place (a fault a training
               cell's numbers are also held against);
  bf16, f64    training, --witness and --f64 seeds: the reference with
               bf16-rounded operands (the program's rounding) and in
               float64 (f32's own), for the look behind the limits;
  program_f32  training, --program_f32 seeds: the program's own f32 path
               (`bf16` off) against the f32 reference.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 … \
        --control 1 2 3 [--faults half_batch …] [--witness 1 2] \
        [--program_f32 1 2] [--out FILE]

Each reading is one JSON line; the benchmark's own runs never run this.
The trainer is built once and re-seeded, so its CUDA graph is captured
once for all seeds (with --free_graph again for each).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import time
from pathlib import Path

import torch

from port_bench import common, compare, data, run, spec


def _ctx(root: Path, workload: str, seed: int, device) -> common.Ctx:
    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    return common.Ctx(
        cell=workload, chips=cell["chips"],
        config=spec.config(bench, root, cell["config"]),
        mix=spec.traffic(bench, root, cell["traffic"]),
        limits=spec.limits(bench, root, workload), seed=seed, seconds=0.0,
        trace=False, device=torch.device(device), tmp=common.scratch(),
        started=time.perf_counter())


def _as_program(cell, other: dict) -> dict:
    """A reference's outputs in the program's place, Adam's counts as
    due."""
    d = cell.spec.d_steps
    return {"count": {"g": cell.k, "ds": cell.k * d, "dt": cell.k * d},
            "end": other["end"], "stats": other["stats"],
            "nu": other["nu"]}


def train_readings(ctx, entry, args):
    cell = entry.TrainCell(ctx)
    d = cell.spec.d_steps
    expected = {"g": cell.k, "ds": cell.k * d, "dt": cell.k * d}
    for seed in args.seeds:
        cell.reseed(seed)
        prog = entry.on_device(cell.call1(), ctx.device)
        if args.free_graph:
            cell.drop_graph()
        if ctx.on_card:
            torch.cuda.empty_cache()
        ref = cell.reference(seed)
        made = cell.made()
        out = compare.train_numbers(expected, prog, ref, made)
        out["look"] = candidates(prog, ref, made)
        yield seed, "program", out
        kinds = []
        if seed in args.control:
            kinds += [("control", {"prec": "fp8"})]
            kinds += [(f, {"fault": f}) for f in args.faults]
        if seed in args.witness:
            kinds += [("bf16", {"prec": "bf16"})]
        if seed in args.f64:
            kinds += [("f64", {"prec": "f64"})]
        for kind, kw in kinds:
            if ctx.on_card:
                torch.cuda.empty_cache()
            other = cell.reference(seed, **kw)
            out = compare.train_numbers(expected, _as_program(cell, other),
                                        ref, made)
            out["look"] = candidates(other, ref, made)
            yield seed, kind, out
            del other
        del prog, ref, made
    if not args.program_f32:
        return
    cell.free()
    del cell
    f32 = copy.deepcopy(ctx)
    f32.config["flags"]["bf16"] = False
    cell = entry.TrainCell(f32)
    for seed in args.program_f32:
        cell.reseed(seed)
        prog = entry.on_device(cell.call1(), ctx.device)
        ref = cell.reference(seed)
        made = cell.made()
        out = compare.train_numbers(expected, prog, ref, made)
        out["look"] = candidates(prog, ref, made)
        yield seed, "program_f32", out
        del prog, ref, made


def candidates(x: dict, ref: dict, made: dict) -> dict:
    """The look behind the limits: what a training check would compare
    first, of x against the reference, that the cells do not: the first
    step's and every step's losses (the largest relative gap, against at
    least 1), and the worst leaf's change and √ν gaps."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1.0)
    out = {"loss1": max(rel(x["losses"][n][0], ref["losses"][n][0])
                        for n in compare.LOSSES),
           "loss_all": max(rel(a, b) for n in compare.LOSSES
                           for a, b in zip(x["losses"][n],
                                           ref["losses"][n]))}
    flat = compare.flat_leaves(ref["nu"])
    s = compare.joined(made["end"], compare.ENDS)
    keep = set(s) - flat
    dx = {p: v - s[p] for p, v in
          compare.joined(x["end"], compare.ENDS).items() if p in keep}
    dr = {p: v - s[p] for p, v in
          compare.joined(ref["end"], compare.ENDS).items() if p in keep}
    out["change_worst"] = max(compare.leaf_gaps(dx, dr).values())
    root = lambda t: {p: v.sqrt() for p, v in compare.joined(t).items()
                      if p in keep}
    out["grad_worst"] = max(compare.leaf_gaps(root(x["nu"]),
                                              root(ref["nu"])).values())
    return out


def sample_readings(ctx, entry, args):
    from dvdgan_tpu_torch.train import step as step_mod
    for seed in args.seeds:
        ctx.seed = seed
        cell = entry.SampleCell(ctx)
        batches = entry.kept_batches(seed, 1000, ctx.mix["check_batches"])
        prog = {}
        for i in batches:
            z, y = data.sample_inputs(seed, i, cell.b, cell.spec.z_dim,
                                      cell.spec.n_classes, cell.dtype,
                                      ctx.device)
            prog[i] = step_mod.sample(*cell.g, z, y, cell.g_cfg).float()
        cell.free()
        ref = cell.reference(seed, batches)
        yield seed, "program", compare.clip_numbers(
            [(prog[i], ref[i]) for i in batches])
        if seed in args.control:
            low = cell.reference(seed, batches, prec="fp8")
            yield seed, "control", compare.clip_numbers(
                [(low[i], ref[i]) for i in batches])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--free_graph", action="store_true",
                   help="free the trainer's CUDA graph before the "
                        "references (a cell whose graph and reference do "
                        "not fit together)")
    p.add_argument("--faults", nargs="*", default=[],
                   help="training: faults to plant on the --control seeds")
    p.add_argument("--witness", type=int, nargs="*", default=[],
                   help="training: seeds for the bf16-rounded reference")
    p.add_argument("--f64", type=int, nargs="*", default=[],
                   help="training: seeds for the float64 reference")
    p.add_argument("--program_f32", type=int, nargs="*", default=[],
                   help="training: seeds for the program's f32 path")
    args = p.parse_args(argv)
    # the trainer's graph pool and up to three references share the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    root = Path.cwd().resolve()
    run.cache_env(root)
    ctx = _ctx(root, args.workload, args.seeds[0], args.device)
    bench = spec.load(root)
    entry = spec.entry(bench, root, ctx.mix["entry"])
    readings = (train_readings if ctx.mix["entry"] == "train"
                else sample_readings)
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for seed, kind, numbers in readings(ctx, entry, args):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, **numbers}), file=out,
                  flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
