"""One run of one benchmark cell of `dvdgan_tpu_torch` on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. Prints the result
as the last line of standard output (one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared with their limits, which also end standard error). Exits non-zero
without a result where no card (or too few) is visible, where the program
cannot be imported, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dvdgan_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's, jaxlib's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["DVDGAN_TORCH_KERNEL_DIR"] = str(
        root / "dvdgan_tpu_torch" / "kernels" / "build")
    cache = root / ".port_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device=None, started: float = STARTED) -> dict:
    """The result line of one run. `device` None: the card (cuda:0); a
    test passes the CPU, where no device number is reported."""
    import torch

    from port_bench import common, spec
    bench = spec.load(root)
    spec.validate(bench, root)
    cell = spec.cell(bench, workload)
    dev = torch.device(device or "cuda:0")
    tmp = common.scratch()
    ctx = common.Ctx(
        cell=workload, chips=cell["chips"],
        config=spec.config(bench, root, cell["config"]),
        mix=spec.traffic(bench, root, cell["traffic"]),
        limits=spec.limits(bench, root, workload), seed=seed,
        seconds=seconds, trace=traced, device=dev, tmp=tmp, started=started)
    try:
        out = spec.entry(bench, root, ctx.mix["entry"]).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok, checks = common.judge(out.numbers, ctx.limits)
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not traced:
        for m in spec.e2e_of(bench, workload):
            if m["name"] in out.e2e:
                metrics[m["name"]] = out.e2e[m["name"]]
            elif ctx.on_card:
                raise RuntimeError(f"{m['name']} was not measured")
    elif out.readings is not None:
        for m in spec.per_layer_of(bench, workload):
            v = spec.metric(bench, root, m["name"]).read(out.readings)
            if v is not None:
                metrics[m["name"]] = v
    line = {"correct": bool(ok and out.failed == 0),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in metrics.items()}}
    if ctx.on_card:
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": ctx.chips,
                       "memory_peak_bytes": out.memory_peak_bytes}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1}
    if out.readings is not None:
        tl = out.readings.timeline
        n = out.readings.units_traced
        out.notes.append("device ms a unit by kernel family: " + ", ".join(
            f"{fam} {tl.family_s(fam) * 1e3 / n:.3f}" for fam in
            ("gru", "port", "library", "elementwise", "nccl"))
            + f", copies and fills {tl.copy_s * 1e3 / n:.3f}; busy "
            f"{tl.busy_s * 1e3 / n:.3f} of {tl.window_s * 1e3 / n:.3f}")
        device_info.update(busy_s=tl.busy_s, window_s=tl.window_s)
        line["breakdown"] = {"device_ops": tl.top_ops(),
                             "idle_gaps": tl.top_gaps()}
    line["device"] = device_info
    line["notes"] = out.notes
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd().resolve()
    cache_env(root)
    try:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        chips = next(c["chips"] for c in bench["workloads"]
                     if c["name"] == args.workload)
    except (OSError, ValueError, StopIteration) as e:
        print(f"port_bench: no workload {args.workload!r} here: {e}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    line = run_cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded {found}: the run may load neither JAX "
              f"nor the JAX package", file=sys.stderr)
        return 4
    for note in line.pop("notes"):
        print(note, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
