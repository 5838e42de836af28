"""The serving artifact (`dvdgan_tpu_torch/serving.py`,
`tools/torch_export_serving.py`) and the serving rate tool
(`tools/torch_bench_sample.py`), port vs dvdgan_tpu's
`tools/export_serving.py` and `train/step.sample`.

Two artifacts, exported once for the module on the CPU from reference
states crossed through `interop`: DVD-GAN-FP in f32 with a polymorphic
batch, and synthesis in bf16 (also polymorphic) with both fused routes,
so that it holds K1's, K5a's and K6a's registered ops.

  * each artifact, saved and loaded, gives the port's `step.sample` of
    the same weights and inputs bitwise, at batches 1 and 3 (the f32
    clip; the bf16 one cast to f32);
  * the FP artifact is within atol 1e-4 of the reference's `step.sample`
    (the sample parity limit of `test_torch_port_sample.py`);
  * the bf16 artifact bakes bf16 weights and f32 BN statistics, takes and
    returns f32, and lies 0 < d < 0.06 from the f32 clip (the reference
    artifact test's bounds);
  * an unknown dtype raises; the graph holds `dvdgan::` op nodes, which a
    run dispatches, while eager sampling dispatches none and K1's entry
    keeps its launch counter and its bits;
  * a process that imports only torch and `kernels.library` loads and
    runs an artifact (the model code absent from its `sys.modules`);
  * the rate tool prints the reference's line on the CPU.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu_torch import interop, serving
from dvdgan_tpu_torch.kernels import convgru_seq
from dvdgan_tpu_torch.models import GConfig
from dvdgan_tpu_torch.train import step
from tools import torch_bench_sample

from test_torch_port_sample import TINY, _sn_u, _unflat, reference_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP_KW = dict(TINY, n_frames=2, cond_frames=2)
SYN_ROUTES = dict(ups_fused="fwd", attn_fused="on")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it
    (`test_torch_port_fp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{name: (flat reference state, GeneratorState, GConfig, dtype,
    program, saved path)} of the two artifacts."""
    root = tmp_path_factory.mktemp("serving")
    out = {}
    for name, kw, routes, dtype, seed in (
            ("fp", FP_KW, {}, "float32", 0),
            ("bf16", TINY, SYN_ROUTES, "bfloat16", 1)):
        flat = reference_state(kw, seed)
        state = interop.load_generator_state(flat)
        cfg = GConfig(**kw, **routes)
        program = serving.export_sampler(state, cfg, 0, "cpu", dtype)
        path = str(root / f"{name}.pt2")
        torch.export.save(program, path)
        out[name] = (flat, state, cfg, serving.DTYPES[dtype], program, path)
    return out


def inputs(cfg: GConfig, b: int, seed: int):
    rng = np.random.RandomState(seed)
    z = rng.randn(b, cfg.z_dim).astype(np.float32)
    y = rng.randint(0, cfg.n_classes, b).astype(np.int32)
    args = [torch.from_numpy(z), torch.from_numpy(y).long()]
    if cfg.cond_frames:
        args.append(torch.from_numpy(np.tanh(rng.randn(
            b, cfg.cond_frames, cfg.img_size, cfg.img_size, 3)).astype(
                np.float32)))
    return args


def eager(state, cfg: GConfig, dtype, z, y, cond=None) -> torch.Tensor:
    return step.sample(*state.trees(), z.to(dtype), y, cfg,
                       cond_video=None if cond is None else cond.to(dtype))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name", ["fp", "bf16"])
def test_artifact_equals_step_sample_bitwise(artifacts, name, b):
    _, state, cfg, dtype, _, path = artifacts[name]
    args = inputs(cfg, b, seed=b)
    clips = serving.load_sampler(path)(*args)
    assert clips.dtype == torch.float32
    assert clips.shape == (b, cfg.n_frames, cfg.img_size, cfg.img_size, 3)
    assert torch.equal(clips, eager(state, cfg, dtype, *args).float())


def test_fp_artifact_matches_reference_sample(artifacts):
    flat, _, cfg, _, _, path = artifacts["fp"]
    z, y, cond = inputs(cfg, 3, seed=7)
    ref = jax.jit(jstep.sample, static_argnames=("g_cfg",))(
        _unflat(flat, "g_ema/"), _unflat(flat, "g/stats/"), _sn_u(flat),
        jnp.asarray(z.numpy()), jnp.asarray(y.numpy(), jnp.int32),
        g_cfg=JGConfig(**FP_KW), cond_video=jnp.asarray(cond.numpy()))
    clips = serving.load_sampler(path)(z, y, cond)
    np.testing.assert_allclose(clips.numpy(), np.asarray(ref), atol=1e-4)


def test_bf16_artifact_bakes_bf16_weights_and_keeps_f32_io(artifacts):
    _, state, cfg, _, program, path = artifacts["bf16"]
    consts = torch.export.load(path).state_dict
    params = {k: v for k, v in consts.items() if k.startswith("params.")}
    stats = {k: v for k, v in consts.items() if k.startswith("stats.")}
    assert len(params) > 40 and len(stats) > 10
    assert len(params) + len(stats) == len(consts)
    assert {v.dtype for v in params.values()} == {torch.bfloat16}
    assert {v.dtype for v in stats.values()} == {torch.float32}
    args = inputs(cfg, 2, seed=5)
    got = serving.load_sampler(path)(*args)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # the f32 clip of the same weights (an f32 artifact's bits: the FP
    # artifact's test above)
    d = float((got - eager(state, cfg, torch.float32, *args)).abs().max())
    assert 0 < d < 0.06, d


def test_unknown_dtype_raises(artifacts):
    _, state, cfg, *_ = artifacts["fp"]
    with pytest.raises(ValueError, match="dtype"):
        serving.export_sampler(state, cfg, 2, "cpu", "fp8")


class Dispatched(TorchDispatchMode):
    """The namespaces of the ops dispatched meanwhile."""

    def __init__(self):
        super().__init__()
        self.seen: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.namespace)
        self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_graph_holds_the_registered_ops_and_eager_calls_none(artifacts):
    _, state, cfg, dtype, program, path = artifacts["fp"]
    n = cfg.n_levels
    # the warm-up's and the generation's GRU at each level
    assert serving.op_counts(program) == {"dvdgan::gru_sequence_fused": 2 * n}
    assert serving.op_counts(artifacts["bf16"][4]) == {
        "dvdgan::gru_sequence_fused": n, "dvdgan::ups2x": n,
        "dvdgan::spatial_attn_fused": 1}
    args = inputs(cfg, 2, seed=3)
    with Dispatched() as run:
        serving.load_sampler(path)(*args)
    assert run.seen["dvdgan"] == 2 * n
    before = convgru_seq.gru_sequence_fused.launches
    with Dispatched() as run:
        eager(state, cfg, dtype, *args)
    assert "dvdgan" not in run.seen and run.seen["aten"] > 100
    # K1's eager entry on CPU tensors: its plain version's bits, no launch
    rng = np.random.RandomState(0)
    t, b, h, w, c = 3, 2, 4, 4, 8
    gx, cx, h0, wg, wc = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                          for s in ((t, b, h, w, 2 * c), (t, b, h, w, c),
                                    (b, h, w, c), (3, 3, c, 2 * c),
                                    (3, 3, c, c)))
    assert torch.equal(convgru_seq.gru_sequence_fused(gx, cx, h0, wg, wc),
                       convgru_seq.gru_sequence_reference(gx, cx, h0, wg, wc))
    assert convgru_seq.gru_sequence_fused.launches == before


CHILD = """
import sys
import numpy as np
import torch
from dvdgan_tpu_torch.kernels import library
program = torch.export.load(sys.argv[1])
with np.load(sys.argv[2]) as f:
    args = [torch.from_numpy(f[k]) for k in ("z", "y", "cond")]
np.save(sys.argv[3], program.module()(*args).numpy())
print(sorted(m for m in sys.modules if m.startswith("dvdgan_tpu")))
"""


def test_artifact_runs_without_the_model_code(artifacts, tmp_path):
    _, state, cfg, dtype, _, path = artifacts["fp"]
    z, y, cond = inputs(cfg, 2, seed=11)
    np.savez(tmp_path / "in.npz", z=z.numpy(), y=y.numpy(),
             cond=cond.numpy())
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, path, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    modules = eval(proc.stdout.strip().splitlines()[-1])
    assert "dvdgan_tpu_torch.kernels.library" in modules
    assert not [m for m in modules if m.startswith(
        ("dvdgan_tpu_torch.models", "dvdgan_tpu_torch.ops",
         "dvdgan_tpu_torch.train", "dvdgan_tpu."))] and "dvdgan_tpu" \
        not in modules
    clips = torch.from_numpy(np.load(tmp_path / "out.npy"))
    assert torch.equal(clips, eager(state, cfg, dtype, z, y, cond))


LINE = re.compile(r"^batch +(\d+): +[\d.]+ clips/s +\( *[\d.]+ ms/clip, "
                  r"+[\d.]+ ms/batch\)")


def test_bench_tool_prints_the_reference_line_on_the_cpu(capsys):
    rows = torch_bench_sample.main([
        "1", "3", "--device", "cpu", "--bf16", "0", "--img_size", "32",
        "--n_frames", "4", "--ch", "8", "--n_classes", "5", "--emb_dim",
        "16", "--attn_res", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [int(LINE.match(ln).group(1)) for ln in lines] == [1, 3]
    assert [r["batch"] for r in rows] == [1, 3]
    assert all(r["eager_s"] > 0 and "graph_s" not in r for r in rows)
