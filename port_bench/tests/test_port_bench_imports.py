"""What the benchmark loads: the harness, every configuration, traffic,
limit, metric and entry file, the reference, and the program's modules the
entries drive pull in neither JAX, jaxlib, flax nor the JAX package
(compared by whole top-level names: the port's own name begins with the
JAX package's). The reference pulls in nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from port_bench.tests.smoke import REPO

LOAD_ALL = r"""
import json, sys
from pathlib import Path
from port_bench import run, spec, calibrate
root = Path(sys.argv[1])
bench = spec.load(root)
spec.validate(bench, root)          # every config, traffic, limit, metric
for c in bench["workloads"]:
    spec.entry(bench, root, spec.traffic(bench, root, c["traffic"])["entry"])
import dvdgan_tpu_torch.train.trainer, dvdgan_tpu_torch.train.step
import dvdgan_tpu_torch.data, dvdgan_tpu_torch.utils.config
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = r"""
import json, sys
import port_bench.reference.model
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str, *args: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    names = _top_level(LOAD_ALL, str(REPO))
    assert "dvdgan_tpu_torch" in names and "port_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "dvdgan_tpu"}, names


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE_ONLY)
    assert not names & {"jax", "jaxlib", "flax", "dvdgan_tpu",
                        "dvdgan_tpu_torch"}, names


def test_forbidden_is_by_whole_top_level_name(monkeypatch):
    from port_bench import run
    monkeypatch.setitem(sys.modules, "dvdgan_tpu_torch_like", sys)
    assert "dvdgan_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dvdgan_tpu.models", sys)
    assert "dvdgan_tpu" in run.forbidden_modules()
