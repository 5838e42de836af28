"""`BENCHMARK.json` and the files it names, found by name and checked.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under the benchmark's directory:

    configs/<config>.json    the configuration as run (port flags, source,
                             `reduced`, `assumed`, the deployment)
    traffic/<traffic>.json   the mix: the entry it drives and its parameters
    limits/<cell>.json       the limit of each number the cell compares
    metrics/<metric>.py      a per-layer metric: LAYER, UNIT, SOURCE, MOVES,
                             BETTER and read(readings) -> float | None
    entries/<entry>.py       the code a mix drives: run(ctx) -> Outcome

A later cell, mix, configuration or metric is added as files and entries,
without an edit to a file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
# a width may not be cut: a configuration's `reduced` names none of these
WIDTHS = re.compile(r"(_dim|_rank)$|^(ch|d_ch|emb_dim|z_dim|k_frames)$")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names breaks the contract."""


def load(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def bench_dir(bench: dict, root: Path) -> Path:
    """The benchmark's own directory: the first of `paths`."""
    return root / bench["paths"][0]


def _line(text, what: str, limit: int = 200) -> None:
    if (not isinstance(text, str) or not 1 <= len(text) <= limit
            or "\n" in text or "\t" in text):
        raise SpecError(f"{what}: 1 to {limit} characters on one line")


def _name(text, what: str) -> None:
    if not isinstance(text, str) or not NAME.match(text):
        raise SpecError(f"{what} {text!r}: not a valid name")


def config(bench: dict, root: Path, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())


def traffic(bench: dict, root: Path, name: str) -> dict:
    path = bench_dir(bench, root) / "traffic" / f"{name}.json"
    return json.loads(path.read_text())


def limits(bench: dict, root: Path, cell: str) -> dict[str, float]:
    path = bench_dir(bench, root) / "limits" / f"{cell}.json"
    return json.loads(path.read_text())["limits"]


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(bench: dict, root: Path, name: str):
    """The per-layer metric's reader module, found by its name."""
    path = bench_dir(bench, root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"per-layer metric {name!r} has no {path}")
    return _module(path, "port_bench_metric_" + re.sub(r"\W", "_", name))


def entry(bench: dict, root: Path, name: str):
    """The code a traffic mix drives, by the mix's `entry`."""
    path = bench_dir(bench, root) / "entries" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"entry {name!r} has no {path}")
    return _module(path, f"port_bench_entry_{name}")


def e2e_of(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_of(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list where the cell reports the metric they move."""
    moved = {m["name"] for m in e2e_of(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def validate(bench: dict, root: Path) -> None:
    """Raises SpecError where the file or a file it names breaks the
    contract; reads every configuration, mix, limit and metric module."""
    if set(bench) != TOP_KEYS:
        raise SpecError(f"BENCHMARK.json keys {sorted(bench)} != "
                        f"{sorted(TOP_KEYS)}")
    cmd = bench["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        raise SpecError("command: a list of 1 to 32 strings")
    for w in cmd:
        _line(w, "command word")
        if w.startswith("/") or ".." in w.split("/"):
            raise SpecError(f"command word {w!r} leads out of the repo")
    paths = bench["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        raise SpecError("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            raise SpecError(f"path {p!r}")
        if not (root / p).is_dir():
            raise SpecError(f"path {p!r} is not a directory")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        raise SpecError("run_seconds: a whole number from 1 to 51")

    names: set[str] = set()

    def unique(n: str, what: str) -> None:
        _name(n, what)
        if n in names:
            raise SpecError(f"{what} {n!r} is not unique")
        names.add(n)

    configs = bench["configs"]
    if not 1 <= len(configs) <= 24:
        raise SpecError("configs: 1 to 24")
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            raise SpecError(f"config {c.get('name')}: keys {sorted(c)}")
        unique(c["name"], "config")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            raise SpecError(f"config {c['name']}: file outside paths")
        if c["file"] in files:
            raise SpecError(f"config {c['name']}: file shared")
        files.add(c["file"])
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise SpecError(f"config {c['name']}: reduced, at most 16 keys")
        body = json.loads((root / c["file"]).read_text())
        for k in c["reduced"]:
            _name(k, f"config {c['name']} reduced key")
            if WIDTHS.search(k):
                raise SpecError(f"config {c['name']}: {k!r} is a width")
        if sorted(body.get("reduced", [])) != sorted(c["reduced"]):
            raise SpecError(f"config {c['name']}: reduced differs from "
                            f"its file's")

    e2e = bench["end_to_end"]
    if not 1 <= len(e2e) <= 16:
        raise SpecError("end_to_end: 1 to 16 metrics")
    if "setup_s" not in {m["name"] for m in e2e}:
        raise SpecError("end_to_end: setup_s is missing")
    for m in e2e:
        if set(m) - {"workloads"} != E2E_KEYS:
            raise SpecError(f"end-to-end {m.get('name')}: keys {sorted(m)}")
        unique(m["name"], "metric")
        _metric_common(m)
        if m["source"] not in E2E_SOURCES:
            raise SpecError(f"{m['name']}: source {m['source']!r}")
        b = m["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            raise SpecError(f"{m['name']}: bound {b} outside [0.01, 0.25]")

    cells = bench["workloads"]
    if not 1 <= len(cells) <= 24:
        raise SpecError("workloads: 1 to 24 cells")
    pairs = set()
    config_names = {c["name"] for c in configs}
    four = 0
    for w in cells:
        if set(w) != CELL_KEYS:
            raise SpecError(f"cell {w.get('name')}: keys {sorted(w)}")
        unique(w["name"], "cell")
        _name(w["traffic"], "traffic")
        _line(w["why"], f"cell {w['name']} why")
        if w["config"] not in config_names:
            raise SpecError(f"cell {w['name']}: config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"cell {w['name']}: chips 1 or 4")
        four += w["chips"] == 4
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            raise SpecError(f"cell {w['name']}: pair {pair} repeated")
        pairs.add(pair)
        mix = traffic(bench, root, w["traffic"])
        entry(bench, root, mix["entry"])
        lim = limits(bench, root, w["name"])
        if not lim or not all(isinstance(v, (int, float))
                              for v in lim.values()):
            raise SpecError(f"cell {w['name']}: no limits")
    if four > max(1, len(cells) // 4):
        raise SpecError(f"{four} cells on 4 chips: at most 25%")
    used = {w["config"] for w in cells}
    if used != config_names:
        raise SpecError(f"configs used by no cell: {config_names - used}")
    cell_names = {w["name"] for w in cells}

    layers = bench["per_layer"]
    if not 1 <= len(layers) <= 128:
        raise SpecError("per_layer: 1 to 128 metrics")
    e2e_names = {m["name"] for m in e2e}
    for m in layers:
        if set(m) - {"workloads"} != LAYER_KEYS:
            raise SpecError(f"per-layer {m.get('name')}: keys {sorted(m)}")
        unique(m["name"], "metric")
        _metric_common(m)
        _line(m["layer"], f"{m['name']} layer")
        if m["source"] not in SOURCES:
            raise SpecError(f"{m['name']}: source {m['source']!r}")
        if m["moves"] not in e2e_names:
            raise SpecError(f"{m['name']}: moves {m['moves']!r}")
        mod = metric(bench, root, m["name"])
        for key in ("layer", "unit", "source", "moves", "better"):
            if getattr(mod, key.upper()) != m[key]:
                raise SpecError(f"{m['name']}: {key} differs from its "
                                f"module's")
        for w in m.get("workloads", []):
            if w not in cell_names:
                raise SpecError(f"{m['name']}: no cell {w!r}")
            if m["moves"] not in {e["name"] for e in e2e_of(bench, w)}:
                raise SpecError(f"{m['name']}: cell {w} does not report "
                                f"{m['moves']}")
    for w in cell_names:
        reported = [e["name"] for e in e2e_of(bench, w)]
        if "setup_s" not in reported or len(reported) < 2:
            raise SpecError(f"cell {w}: setup_s and another end-to-end "
                            f"metric")
        if not per_layer_of(bench, w):
            raise SpecError(f"cell {w}: no per-layer metric")
    if len(json.dumps(bench, indent=1)) > 64 * 1024:
        raise SpecError("BENCHMARK.json over 64 KiB")


def _metric_common(m: dict) -> None:
    if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
        raise SpecError(f"{m['name']}: unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        raise SpecError(f"{m['name']}: better {m['better']!r}")
    for w in m.get("workloads", []):
        _name(w, f"{m['name']} workload")
