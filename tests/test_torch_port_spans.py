"""The port's spans and counters (`dvdgan_tpu_torch/utils/profiling.py`) and
the benchmark's reader of them (`port_bench/spans.py`).

On the CPU: `span` off is one shared null context that records and
launches nothing; on, it leaves `dvdgan.*` ranges in a profiler trace; under
a capture (simulated: the capture test and the marker launch stubbed) a
train step's markers stand for balanced, ordered spans with the step's
phases at the top; the counters move; the trainer's log line carries the
loader wait; the reader splits a synthetic Chrome trace (graph markers on
one stream, an NCCL-like kernel on another, eager kernels by correlation)
into device time and idle gaps by program span, and leaves
`port_bench/trace.py:reduce` as it reads without program spans; the new
metric files agree with BENCHMARK.json. On the card (marked `gpu`, skipped
without one): a graph captured with spans off holds no marker, spans on
add the markers and nothing else, change no bit of the state, and the
graph's kernel, memcpy and memset nodes are the device operations a
profiler sees a replay (it shows each memcpy node as a kernel,
`memcpy32_post`, so its kernels a step exceed `kernel_nodes` by those).
"""

from __future__ import annotations

import copy
import functools
import json
from pathlib import Path

import pytest
import torch

from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step as step_mod
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging
from dvdgan_tpu_torch.utils import profiling
from dvdgan_tpu_torch.utils.config import Config
from port_bench import spans as pspans
from port_bench import spec
from port_bench import trace as ptrace

REPO = Path(__file__).resolve().parents[1]
KW = dict(dataset="synthetic", n_classes=5, img_size=32, n_frames=4, ch=8,
          d_ch=8, emb_dim=16, attn_res=16, k_frames=2, batch_size=2,
          d_steps=2, bf16=False, ema_start=0, seed=5, device="cpu",
          log_step=2, sample_step=0, model_save_step=0, total_step=4)
TRAIN_CELLS = ["ucf101_64.train", "kinetics_256_48f.train"]
# each new metric: its cells, and its reading of the counters below
NEW_METRICS = {"kernels_per_step.train": (TRAIN_CELLS, 812.5),
               "loader_wait_ms.train": (TRAIN_CELLS, 125.0),
               "sample_issue_ms.sample": (["ucf101_64.sample"], 2.5)}


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off, the process default."""
    profiling.enable(False)
    yield
    profiling.enable(False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(trace_dir: Path) -> set[str]:
    (path,) = trace_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return {e.get("name") for e in events}


def _sampler():
    cfg = Config(**KW)
    g_cfg = cfg.g_config()
    trees = GeneratorState.create(g_cfg, 0).trees()
    z = torch.randn(2, g_cfg.z_dim,
                    generator=torch.Generator().manual_seed(1))
    return functools.partial(step_mod.sample, *trees, z,
                             torch.tensor([0, 3]), g_cfg)


@pytest.fixture
def fake_capture(monkeypatch):
    """A capture as `span` sees one: the stream capturing, each marker
    launch recorded (by its place in the marks) instead of made."""
    launched = []
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    monkeypatch.setattr(profiling, "_launch_mark", launched.append)
    return launched


def test_span_off_is_one_shared_null_context(tmp_path, fake_capture):
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("step.d")
    with profiling.recording_marks() as marks:
        with profiling.span("a"):
            pass
    assert marks == [] and fake_capture == []
    with profiling.trace(str(tmp_path)):
        _sampler()()
    assert not [n for n in _names(tmp_path)
                if n and n.startswith(profiling.PREFIX)]


def test_span_on_leaves_dvdgan_ranges_in_a_cpu_trace(tmp_path):
    profiling.enable(True)
    with profiling.trace(str(tmp_path)):
        _sampler()()
    names = _names(tmp_path)
    for span in ("sample", "sn", "g.0", "g.1", "g.head"):
        assert profiling.PREFIX + span in names, span


def test_span_on_under_a_capture_records_balanced_marks(fake_capture):
    profiling.enable(True)
    with profiling.recording_marks() as marks:
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    assert marks == [("a", "B"), ("b", "B"), ("b", "E"), ("a", "E")]
    assert fake_capture == [0, 1, 2, 3]


def _tiny_step():
    """A train step at the test scale, its draws made afresh each call."""
    cfg = Config(**KW)
    g, ds, dt = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    st = train_state.create(0, g, ds, dt)
    real = torch.rand(2, 4, 32, 32, 3,
                      generator=torch.Generator().manual_seed(2)) * 2 - 1

    def step():
        draws = step_mod.TorchDraws(0, 0, 2, g.z_dim, g.n_frames,
                                    ds.k_frames, torch.float32, "cpu")
        return step_mod.train_step(st, real, torch.tensor([1, 2]), draws,
                                   g, ds, dt, cfg.train_config())
    return step


def test_train_step_marks_nest_under_its_phases(fake_capture):
    step = _tiny_step()
    profiling.enable(True)
    with profiling.recording_marks() as marks:
        _, metrics = step()
    assert fake_capture == list(range(len(marks)))
    stack, top, inner = [], [], {}
    for name, kind in marks:
        if kind == "B":
            if not stack:
                top.append(name)
            else:
                inner.setdefault(stack[0], []).append(name)
            stack.append(name)
        else:
            assert stack.pop() == name
    assert stack == []
    assert top == ["step.fakes", "step.d", "step.d", "step.g"]
    d = inner["step.d"]
    assert d.count("sn") == 4 and d.count("adam") == 4   # 2 D steps
    assert inner["step.fakes"][:2] == ["sn", "g.0"]
    g = inner["step.g"]
    assert g.count("sn") == 3 and g.count("adam") == 1
    assert g.count("ema") == 1 and "g.head" in g
    # the marks change nothing the step computes
    profiling.enable(False)
    _, plain = step()
    assert all(torch.equal(metrics[k], plain[k]) for k in plain)


def test_sample_counts_its_host_time(monkeypatch):
    run = _sampler()
    monkeypatch.setattr(profiling, "COUNTERS", profiling.Counters())
    run()       # the process's first call, kept apart
    first = profiling.COUNTERS.snapshot()
    assert first["sample_first_s"] > 0 and first["sample_calls"] == 0
    assert first["sample_issue_s"] == 0
    run()
    run()
    after = profiling.COUNTERS.snapshot()
    assert after["sample_first_s"] == first["sample_first_s"]
    assert after["sample_calls"] == 2 and after["sample_issue_s"] > 0


@pytest.mark.parametrize("k", [1, 2])
def test_trainer_counts_the_loader_wait_and_logs_it(tmp_path, capsys,
                                                    monkeypatch, k):
    monkeypatch.setattr(trainer_mod, "MetricWriter", functools.partial(
        plogging.MetricWriter, use_tensorboard=False))
    before = profiling.COUNTERS.snapshot()
    tr = trainer_mod.Trainer(Config(**{**KW, "out_dir": str(tmp_path),
                                       "steps_per_call": k}))
    tr.train()
    tr.close()
    after = profiling.COUNTERS.snapshot()
    # every call but the first waits for the batch prefetched meanwhile
    assert after["loader_wait_steps"] - before["loader_wait_steps"] == 4 - k
    assert after["loader_wait_s"] >= before["loader_wait_s"]
    lines = [plogging.parse_step_line(ln)[1] for ln in
             capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2
    for fields in lines:
        assert fields["loader_wait_ms"] >= 0
        # the CPU runs the K steps eagerly: no graph, no node count
        assert "kernels_per_step" not in fields


# ------------------------------------------------ port_bench/spans.py
MARKS = [("step.d", "B"), ("sn", "B"), ("sn", "E"), ("adam", "B"),
         ("adam", "E"), ("step.d", "E")]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def _kernel(name, ts, dur, corr, stream=7):
    return _x("kernel", name, ts, dur, tid=stream, stream=stream,
              correlation=corr)


def _fixture() -> list[dict]:
    """One graph replay (6 markers on stream 7, an NCCL-like kernel of the
    same launch on stream 9) inside the host span train.call, then eager
    kernels launched inside sample/sn, inside sample and outside all."""
    host = [_x("user_annotation", "bench.traced", 0, 1000),
            _x("user_annotation", "bench.step", 140, 120),
            _x("user_annotation", "dvdgan.train.call", 100, 200),
            _x("user_annotation", "dvdgan.sample", 400, 300),
            _x("user_annotation", "dvdgan.sn", 410, 40),
            _x("cuda_runtime", "cudaGraphLaunch", 150, 5, correlation=10),
            _x("cuda_runtime", "cudaLaunchKernel", 420, 2, correlation=20),
            _x("cuda_runtime", "cudaLaunchKernel", 440, 2, correlation=23),
            _x("cuda_runtime", "cudaLaunchKernel", 500, 2, correlation=21),
            _x("cuda_runtime", "cudaMemcpyAsync", 590, 2, correlation=22),
            _x("cuda_runtime", "cudaLaunchKernel", 800, 2, correlation=30)]
    marks = [_kernel(pspans.MARK_KERNEL, ts, 1, 10)
             for ts in (160, 170, 180, 190, 200, 210)]
    graph = [_kernel("gemm_a", 162, 4, 10),
             _kernel("elementwise_b", 172, 5, 10),
             _kernel("gemm_a", 182, 3, 10),
             _kernel("elementwise_c", 192, 6, 10),
             _kernel("copy_d", 215, 10, 10),
             _kernel("ncclKernel_AllReduce", 175, 20, 10, stream=9)]
    eager = [_kernel("elementwise_e", 425, 10, 20),
             _kernel("elementwise_h", 445, 2, 23),
             _kernel("gemm_f", 505, 20, 21),
             _x("gpu_memcpy", "Memcpy HtoD", 600, 10, tid=7, stream=7,
                correlation=22),
             _kernel("elementwise_g", 805, 5, 30),
             _kernel("after_the_window", 1500, 5, 30)]
    return host + marks + graph + eager


def test_spans_reduce_splits_device_time_and_gaps_by_program_span():
    p = pspans.reduce(_fixture(), MARKS)
    want = {"step.d": 7, "step.d/sn": 5, "step.d/adam": 6, "train.call": 30,
            "sample/sn": 12, "sample": 30, "none": 5, pspans.MARKS: 6}
    assert p.device_s == pytest.approx({k: v / 1e6 for k, v in want.items()})
    by: dict[str, float] = {}
    for label, s in p.gaps:
        by[label] = by.get(label, 0.0) + s
    assert by == pytest.approx({"train.call": 21e-6, "none": 395e-6,
                                "sample/sn": 10e-6, "sample": 133e-6})
    split = pspans.train_split(p)
    assert split["d_update"] == pytest.approx(7e-6)
    assert split["sn"] == pytest.approx(17e-6)
    assert split["optimizer"] == pytest.approx(6e-6)
    assert sum(split.values()) == pytest.approx(sum(p.device_s.values()))


def test_spans_reduce_refuses_a_trace_that_missed_a_marker():
    events = [e for e in _fixture()
              if not (e["name"] == pspans.MARK_KERNEL and e["ts"] == 170)]
    with pytest.raises(ValueError, match="missed"):
        pspans.reduce(events, MARKS)


def test_program_spans_leave_the_benchmark_timeline_as_it_was():
    events = _fixture()
    bare = [e for e in events if not e["name"].startswith(pspans.PREFIX)]
    assert ptrace.reduce(copy.deepcopy(events)) == ptrace.reduce(bare)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metric_files_match_benchmark_json(name, monkeypatch):
    bench = spec.load(REPO)
    spec.validate(bench, REPO)
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    mod = spec.metric(bench, REPO, name)
    for key in ("layer", "unit", "source", "moves", "better"):
        assert getattr(mod, key.upper()) == entry[key]
    cells, reading = NEW_METRICS[name]
    assert entry["workloads"] == cells
    # a program that has not run the metric's path yet: nothing to read
    monkeypatch.setattr(profiling, "COUNTERS", profiling.Counters())
    assert mod.read(None) is None
    monkeypatch.setattr(profiling, "COUNTERS", profiling.Counters(
        loader_wait_s=0.5, loader_wait_steps=4, sample_issue_s=0.01,
        sample_calls=4, kernel_nodes=812.5))
    assert mod.read(None) == pytest.approx(reading)
    # a program without the counters (the parent's): nothing, no error
    monkeypatch.delattr(profiling, "COUNTERS")
    assert mod.read(None) is None


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _multi(device):
    cfg = Config(**KW)
    g, ds, dt = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    st = train_state.to_device(train_state.create(0, g, ds, dt), device)
    multi = step_mod.MultiStep(st, 2, 2, g, ds, dt, cfg.train_config(), 0,
                               torch.float32, device)
    reals = torch.rand(2, 2, 4, 32, 32, 3, device=device) * 2 - 1
    ys = torch.tensor([[1, 2], [0, 4]], device=device)
    return multi, (reals, ys)


def _replay_trace(multi, tmp: Path) -> list[dict]:
    with profiling.trace(str(tmp)):
        multi.graph.replay()
    (path,) = tmp.glob("*.pt.trace.json")
    return json.loads(path.read_text())["traceEvents"]


@pytest.mark.gpu
def test_markers_on_the_card_add_themselves_and_nothing_else(cuda, tmp_path):
    """Under deterministic cuDNN: its default f32 weight gradients differ
    from run to run (`test_torch_port_gpu.py`)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        _markers_add_themselves_and_nothing_else(cuda, tmp_path)


def _markers_add_themselves_and_nothing_else(cuda, tmp_path):
    off, batch = _multi(cuda)
    start = copy.deepcopy(off.state)
    # a copy: the traced replay below goes on from the graph's buffers
    off_state = copy.deepcopy(off(off.state, *batch, 0)[0])
    assert off.marks == [] and off.kernel_nodes > 0
    events = _replay_trace(off, tmp_path / "off")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert not [e for e in kernels if e["name"] == pspans.MARK_KERNEL]
    ops = [e for e in events if e.get("cat") in ptrace.DEVICE_CATS]
    nodes = sum(off.nodes[t] for t in ("kernel", "memcpy", "memset"))
    print(f"kernel_nodes {off.kernel_nodes} a step; the profiler saw "
          f"{len(kernels) / off.k} kernels a step "
          f"({len(kernels) / off.k - off.kernel_nodes:+g}) and "
          f"{len(ops)} device operations of {nodes} nodes {off.nodes}")
    assert 0.99 * nodes <= len(ops) <= nodes
    assert len(kernels) >= 0.99 * off.nodes["kernel"]

    profiling.enable(True)
    on, _ = _multi(cuda)
    on_state, _ = on(start, *batch, 0)
    assert on.marks and on.kernel_nodes == off.kernel_nodes
    assert on.nodes["kernel"] == off.nodes["kernel"] + len(on.marks)
    assert profiling.COUNTERS.kernel_nodes == on.kernel_nodes
    flat = lambda t: list(step_mod.tru.flatten_with_paths(t).values())
    assert all(torch.equal(a, b)
               for a, b in zip(flat(on_state), flat(off_state)))
    events = _replay_trace(on, tmp_path / "on")
    marks = [e for e in events if e.get("name") == pspans.MARK_KERNEL]
    assert len(marks) == len(on.marks)
    split = pspans.train_split(pspans.reduce(events, on.marks))
    assert min(split[k] for k in ("fakes", "d_update", "g_update", "sn",
                                  "optimizer")) > 0
