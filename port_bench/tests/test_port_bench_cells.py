"""The benchmark is driven by data: cells, configurations, mixes, limits and
per-layer metrics are files found by name, which a later change adds
without editing one that is there; BENCHMARK.json keeps to the contract's
names, units and arrows; a run's last line has the contract's shape, and a
run on the CPU reports no device number."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from port_bench import run, spec
from port_bench.tests.smoke import REPO, smoke_root

DEVICE_METRICS = {"peak_mem_gib", "device_idle.train", "device_idle.sample",
                  "mfu.train", "mfu.sample", "gru_roofline.train",
                  "gru_roofline.sample", "elementwise_ms.train"}


def test_the_benchmark_meets_the_contract():
    bench = spec.load(REPO)
    spec.validate(bench, REPO)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    for w in bench["workloads"]:
        assert spec.NAME.match(w["name"])
        reported = {e["name"] for e in spec.e2e_of(bench, w["name"])}
        for m in spec.per_layer_of(bench, w["name"]):
            assert m["moves"] in reported, (w["name"], m["name"])
    assert [w["chips"] for w in bench["workloads"]].count(4) <= max(
        1, len(bench["workloads"]) // 4)


PROBE = '''"""A probe metric a later change might add."""
LAYER = "kernels"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_clips_per_s"
BETTER = "lower"


def read(r):
    return 1.0
'''


def test_new_files_are_found_by_name(tmp_path):
    root = smoke_root(tmp_path)
    (root / "port_bench" / "metrics" / "probe_ms.train.py").write_text(PROBE)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "probe_ms.train", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "kernels",
         "moves": "train_clips_per_s", "workloads": ["smoke.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = spec.load(root)
    spec.validate(bench, root)
    names = [m["name"] for m in spec.per_layer_of(bench, "smoke.train")]
    assert "probe_ms.train" in names
    assert spec.metric(bench, root, "probe_ms.train").read(None) == 1.0
    assert spec.config(bench, root, "smoke")["flags"]["ch"] == 16
    assert spec.traffic(bench, root, "train_small")["entry"] == "train"
    assert set(spec.limits(bench, root, "smoke.sample")) == {
        "clip_gap", "clip_rms_gap"}


@pytest.mark.parametrize("breach", [
    ("unit", "tokens per second"), ("name", "has space"),
    ("reduced", ["ch"]), ("moves", "no_such_metric"), ("chips", 2),
    ("bound", 0.5)])
def test_a_breach_of_the_contract_is_refused(tmp_path, breach):
    root = smoke_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    key, value = breach
    target = {"unit": bench["end_to_end"][0], "name": bench["workloads"][0],
              "reduced": bench["configs"][0], "moves": bench["per_layer"][0],
              "chips": bench["workloads"][0],
              "bound": bench["end_to_end"][0]}[key]
    target[key] = value
    with pytest.raises(spec.SpecError):
        spec.validate(bench, root)


@pytest.mark.parametrize("cell", ["smoke.train", "smoke.sample"])
def test_the_last_line_at_smoke_on_the_cpu(tmp_path, cell):
    root = smoke_root(tmp_path)
    line = run.run_cell(root, cell, 2 ** 31 + 11, 1.0, False, device="cpu",
                        started=time.perf_counter())
    line.pop("notes")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert not set(line["metrics"]) & DEVICE_METRICS
    e2e = {m["name"] for m in spec.e2e_of(spec.load(root), cell)}
    assert set(line["metrics"]) == e2e - DEVICE_METRICS
    for m in line["metrics"].values():
        assert m["value"] > 0 and spec.UNIT.match(m["unit"])
    for c in line["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]
    json.dumps(line)


def _command(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "ucf101_64.train", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                          "PYTHONPATH": str(cwd)})


def test_no_card_no_result():
    out = _command(REPO)
    assert out.returncode != 0
    assert not re.search(r'"correct"', out.stdout)


def test_the_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert not re.search(r'"correct"', out.stdout)


def test_the_trace_reduction():
    from port_bench import trace
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.traced",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 0,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "void conv3x3_mma_kernel<T, "
         "GateEpi>(a)", "ts": 1, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm",
         "ts": 20, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void at::native::"
         "elementwise_kernel<128>", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce",
         "ts": 150, "dur": 5}]                # starts outside the span
    tl = trace.reduce(events)
    assert tl.window_s == pytest.approx(64e-6)
    assert tl.busy_s == pytest.approx(30e-6)
    assert [trace.family(n) for n in tl.kernel_s] == [
        "gru", "library", "elementwise"]
    assert tl.top_gaps() == [["step", pytest.approx(34e-6)]]
    assert trace.family("ncclDevKernel_AllReduce") == "nccl"
