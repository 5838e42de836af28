"""The port's collectives over NCCL, one card a rank, on a machine with two
or more CUDA devices: each of `all_mean`, `all_sum`, `halos` (forward and
backward) and `mean_tree` (the gradient mean, no autograd), over the
world and over the data and time groups of a (data × time) mesh, replayed
from a CUDA graph gives its eager bits (the counterpart across cards of
`test_torch_port_gpu.py::test_kernel_replays_from_a_cuda_graph_with_its_eager_bits`),
and the eager results agree with the ranks' inputs; and `MultiStep`'s K
steps captured with the NCCL collectives inside give K eager steps' bits
at the test scale (bf16, img 32), under data parallelism and data × time.

Marked `gpu`; the tests skip (inside the `nccl_ranks` fixture) where fewer
than two cards are visible, since NCCL takes one rank a card. The ranks
are spawned processes (`parallel.mesh.spawn`, up to 4, one card each)
that unpickle their job from this file, so it imports no JAX. Run them on
a machine with several cards:
`python -m pytest tests/test_torch_port_multigpu.py -q --noconftest`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dvdgan_tpu_torch.parallel import collectives
from dvdgan_tpu_torch.parallel import mesh as pmesh
from dvdgan_tpu_torch.train import step

pytestmark = pytest.mark.gpu
CASES = ("all_mean", "all_sum", "halos", "mean_tree")
# eager results against the ranks' inputs summed on the host in float64
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LAUNCH_TIMEOUT_S = 600.0
K = 2
STEP_FLAGS = ["--img_size", "32", "--n_frames", "4", "--ch", "8", "--d_ch",
              "8", "--emb_dim", "16", "--attn_res", "16", "--k_frames", "2",
              "--n_classes", "5", "--bf16", "1", "--d_steps", "1"]


def _draw(seed: int, shape, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def case_inputs(case: str, rank: int, dtype) -> dict:
    """A rank's inputs of a case, drawn on the host from (case, rank)."""
    seed = 1000 * rank + CASES.index(case)
    if case == "halos":
        return {"x": _draw(seed, (2, 3, 4, 4, 8), dtype),
                "w1": _draw(seed + 1, (2, 4, 4, 8), dtype),
                "w2": _draw(seed + 2, (2, 4, 4, 8), dtype)}
    if case == "mean_tree":     # two dtypes, a 64 MiB leaf and small ones
        return {"big": _draw(seed, (4096, 4097)),
                "small": {"a": _draw(seed + 1, (3, 5))},
                "half": _draw(seed + 2, (1000,), torch.bfloat16)}
    return {"x": _draw(seed, (1024, 1027), dtype),
            "w": _draw(seed + 1, (1024, 1027), dtype)}


def case_fn(case: str, group, tree_groups):
    """inputs on the card -> the case's outputs (a flat tuple)."""
    if case == "mean_tree":
        def run(t):
            out = collectives.mean_tree(t, tree_groups)
            return out["big"], out["small"]["a"], out["half"]
        return run
    op = getattr(collectives, case)

    def run(t):
        x = t["x"]
        if case == "halos":
            left, right = op(x, group)
            loss = (left * t["w1"]).float().sum() + 2 * (
                right * t["w2"]).float().sum()
            out = (left, right)
        else:
            y = op(x, group)
            loss = (y * t["w"]).float().sum()
            out = (y,)
        (dx,) = torch.autograd.grad(loss, x)
        return out + (dx,)
    return run


def expected(case: str, ranks: list[int], me: int, dtype) -> tuple:
    """The outputs of a case on rank `me` of the group `ranks`, computed on
    the host from every rank's inputs (sums in float64)."""
    ins = {r: case_inputs(case, r, dtype) for r in ranks}
    if case == "mean_tree":     # the checked leaves: big (f32), half (bf16)
        return tuple(sum(ins[r][k].double() for r in ranks) / len(ranks)
                     for k in ("big", "half"))
    if case == "halos":
        i = ranks.index(me)
        zero = torch.zeros_like(ins[me]["x"][:, 0])
        left = ins[ranks[i - 1]]["x"][:, -1] if i > 0 else zero
        right = ins[ranks[i + 1]]["x"][:, 0] if i < len(ranks) - 1 else zero
        dx = torch.zeros_like(ins[me]["x"])
        if i > 0:           # my first frame was rank i−1's right halo
            dx[:, 0] += 2 * ins[ranks[i - 1]]["w2"]
        if i < len(ranks) - 1:      # my last, rank i+1's left halo
            dx[:, -1] += ins[ranks[i + 1]]["w1"]
        return left, right, dx
    n = len(ranks) if case == "all_mean" else 1
    return (sum(ins[r]["x"].double() for r in ranks) / n,
            sum(ins[r]["w"].double() for r in ranks) / n)


def run_case(case: str, key: str, group, tree_groups, dtype,
             device) -> dict:
    """The case eagerly, then captured after a warm-up on a side stream and
    replayed twice, the outputs poisoned between: -> bitwise equal each
    time, and the eager outputs' largest gap from `expected`, relative to
    max(1, max|expected|)."""
    rank = dist.get_rank()
    static = {k: (v.to(device).requires_grad_(case != "mean_tree")
                  if isinstance(v, torch.Tensor) else
                  {kk: vv.to(device) for kk, vv in v.items()})
              for k, v in case_inputs(case, rank, dtype).items()}
    fn = case_fn(case, group, tree_groups)
    eager = [o.detach().clone() for o in fn(static)]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(static)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=step.capture_mode()):
        outs = fn(static)
    bitwise = []
    for _ in range(2):
        for o in outs:
            o.detach().fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize(device)
        bitwise.append(all(torch.equal(a, b) for a, b in zip(outs, eager)))
    if case == "mean_tree":     # over every rank, group after group
        ranks, got = list(range(dist.get_world_size())), eager[::2]
    else:
        ranks = dist.get_process_group_ranks(group)
        got = eager
    want = expected(case, ranks, rank, dtype)
    gap = max(float((a.double().cpu() - b.double()).abs().max()
                    / max(1.0, float(b.double().abs().max())))
              for a, b in zip(got, want))
    return {"case": case, "group": key, "dtype": str(dtype),
            "bitwise": bitwise, "gap": gap}


def multistep_job(par) -> dict:
    """`MultiStep` of K steps on this rank's card (captured, NCCL inside)
    against the same K steps run eagerly with the groups from the same
    state, buffers and draws: -> bitwise equal, and the leaves that
    differ."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.utils.config import parse_config

    cfg = parse_config(STEP_FLAGS + ["--batch_size", str(2 * par.n_data)])
    g_cfg, ds_cfg, dt_cfg = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    tc = cfg.train_config()
    device = par.device
    lo, hi = pmesh.local_batch_rows(par.mesh, cfg.batch_size, [par.rank])
    gen = torch.Generator().manual_seed(11)
    reals = torch.rand((K, cfg.batch_size, g_cfg.n_frames, 32, 32, 3),
                       generator=gen).mul(2).sub(1)[:, lo:hi]
    ys = torch.randint(0, 5, (K, cfg.batch_size), generator=gen)[:, lo:hi]
    state = train_state.to_device(train_state.create(
        cfg.seed, g_cfg, ds_cfg, dt_cfg), device)
    groups = pmesh.step_groups(par)
    multi = step.MultiStep(state, K, hi - lo, g_cfg, ds_cfg, dt_cfg, tc,
                           cfg.seed, torch.bfloat16, device,
                           shard=pmesh.rank_shard(par), **groups)
    reals = reals.to(device, torch.bfloat16)
    ys = ys.to(device)
    graphed, _ = multi(state, reals, ys, 0)
    digest = interop.state_digest(graphed)[0]
    graphed = interop.train_state_to_flat(graphed)
    st = state
    for j in range(K):
        draws = step.TorchDraws(cfg.seed, j, hi - lo, g_cfg.z_dim,
                                g_cfg.n_frames, ds_cfg.k_frames,
                                torch.bfloat16, device,
                                shard=pmesh.rank_shard(par))
        st, _ = step.train_step(st, reals[j], ys[j], draws, g_cfg, ds_cfg,
                                dt_cfg, tc, **groups)
    eager = interop.train_state_to_flat(st)
    differ = [k for k, v in eager.items()
              if not np.array_equal(v, graphed[k])]
    return {"case": "multistep", "bitwise": [not differ], "differ": differ[:10],
            "leaves": len(eager), "comms": multi.comms, "digest": digest}


def _rank_main(local_rank: int, n_time: int, out: str) -> None:
    world = int(os.environ["WORLD_SIZE"])
    par = pmesh.init_from_env(torch.device("cuda"), n_time, 2 * world)
    device = par.device
    rows = []
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        groups = {"world": dist.group.WORLD, "data": par.data_group,
                  "time": par.time_group}
        for key, group in groups.items():
            for dtype in (torch.float32, torch.bfloat16):
                for case in ("all_mean", "all_sum", "halos"):
                    if group is not None:
                        rows.append(run_case(case, key, group, None, dtype,
                                             device))
        # the gradient mean's groups, as `train_step` passes them
        rows.append(run_case("mean_tree", "data+time", None,
                             [par.data_group, par.time_group], None, device))
        rows.append(multistep_job(par))
    finally:
        with open(os.path.join(out, f"rank{par.rank}.json"), "w") as f:
            json.dump({"backend": par.backend, "rows": rows,
                       "mesh": list(par.mesh.shape)}, f)
        par.close()


@pytest.fixture(scope="module")
def nccl_ranks(tmp_path_factory):
    """One launch of up to 4 ranks, one card each (data × time 2 at 4),
    running every case; -> each rank's results."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices (NCCL takes one rank a "
                    "card)")
    world = min(n, 4)
    out = str(tmp_path_factory.mktemp("nccl"))
    pmesh.spawn(_rank_main, world, (2 if world == 4 else 1, out),
                timeout_s=LAUNCH_TIMEOUT_S)
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


@pytest.mark.parametrize("case", CASES)
def test_collective_replays_from_a_cuda_graph_with_its_eager_bits(
        nccl_ranks, case):
    for r in nccl_ranks:
        assert r["backend"] == "nccl"
        rows = [x for x in r["rows"] if x["case"] == case]
        assert rows
        for x in rows:
            assert x["bitwise"] == [True, True], x
            tol = TOL[torch.bfloat16 if "bfloat16" in x["dtype"]
                      else torch.float32]
            if case == "mean_tree":     # its bf16 leaf sets the limit
                tol = TOL[torch.bfloat16]
            assert x["gap"] <= tol, x


def test_multi_step_under_nccl_gives_k_eager_steps_bits(nccl_ranks):
    rows = [next(x for x in r["rows"] if x["case"] == "multistep")
            for r in nccl_ranks]
    for x in rows:
        assert x["bitwise"] == [True], x["differ"]
        assert x["comms"]["all_reduce"] > 0 and x["comms"]["bytes"] > 0
    # the replicas: one digest on every rank
    assert len({x["digest"] for x in rows}) == 1
