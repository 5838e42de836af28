"""K steps a call under several ranks (`train/step.py:MultiStep` with
`group`/`time_group`, the trainer's `comm_*` fields), on the CPU at the
repo's test scale with gloo ranks (`test_torch_port_parallel.run_ranks`,
one thread a rank). On the card the K steps are one CUDA graph that holds
the NCCL collectives; what a CPU run can hold for it:

  * the warm-up that precedes the capture (`MultiStep.warm_up`) issues the
    same collectives, in the same order, sizes, dtypes and groups, as one
    step with the groups: every group's communicator exists before the
    capture, and the ranks' calls stay matched (a spy on
    `collectives._all_reduce` and `_all_gather`), for data parallelism
    and for data × time;
  * `MultiStep.comms`, the collectives and bytes a step (on the card
    counted around the capture, as `launches`), equal one step's;
  * the trainer's `comm_*` fields at K 2 equal those at K 1 (on the card a
    replay moves no host counter, so they come from `MultiStep`);
  * without the gloo ranks: a rank's share of the host's cores
    (`mesh.share_cores`), the capture mode in a process with an NCCL
    group (`step.capture_mode`) and the NCCL barrier on the rank's own
    card.

Like `test_torch_port_parallel.py`, this file imports no JAX: the ranks
unpickle their jobs from it.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dvdgan_tpu_torch import cli
from dvdgan_tpu_torch.parallel import collectives
from dvdgan_tpu_torch.parallel import mesh as pmesh
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging
from dvdgan_tpu_torch.utils.config import Config
from test_torch_port_parallel import (B, COLLECTIVE_TIMEOUT_S, G_KW,
                                      TRAINER_KW, configs, run_ranks)

K = 2


def _rank_main(local_rank: int, n_time: int, jobs: list[dict], out: str):
    torch.set_num_threads(1)
    par = pmesh.init_from_env(torch.device("cpu"), n_time, B,
                              timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        for job in jobs:
            JOBS[job["kind"]](par, job, out)
    finally:
        par.close()


@contextlib.contextmanager
def spy_collectives(calls: list):
    """Appends (kind, shape, dtype, group ranks) of every all-reduce and
    all-gather issued inside the block to `calls`."""
    real = {"all_reduce": collectives._all_reduce,
            "all_gather": collectives._all_gather}

    def spied(kind, x, group, *args, **kw):
        calls.append((kind, tuple(x.shape), str(x.dtype),
                      tuple(dist.get_process_group_ranks(group))))
        return real[kind](x, group, *args, **kw)

    try:
        for kind in real:
            setattr(collectives, f"_{kind}", functools.partial(spied, kind))
        yield calls
    finally:
        for kind, fn in real.items():
            setattr(collectives, f"_{kind}", fn)


def multi_job(par, job: dict, out: str) -> None:
    """A `MultiStep` of K steps on this rank's rows, its buffers filled by
    one call; then, from its buffers, the warm-up and one step with the
    groups under the spy, and the call's `comms` beside one step's
    `COUNTS`."""
    cfgs = configs({"g": G_KW})
    g_cfg = cfgs[0]
    lo, hi = pmesh.local_batch_rows(par.mesh, B, [par.rank])
    rng = np.random.RandomState(7)
    reals = torch.from_numpy(rng.uniform(-1, 1, (K, B, g_cfg.n_frames, 32,
                                                 32, 3)).astype(np.float32))
    ys = torch.from_numpy(np.stack([rng.permutation(B) % 5
                                    for _ in range(K)]))
    groups = pmesh.step_groups(par)
    multi = step.MultiStep(train_state.create(3, *cfgs[:3]), K, hi - lo,
                           *cfgs, 0, torch.float32, "cpu",
                           shard=pmesh.rank_shard(par), **groups)
    multi(multi.state, reals[:, lo:hi], ys[:, lo:hi], 0)
    warm, one = [], []
    with spy_collectives(warm):
        multi.warm_up()
    before = collectives.COUNTS.snapshot()
    with spy_collectives(one):
        step.train_step(multi.state, multi.reals[0], multi.ys[0],
                        multi.draws[0], *cfgs, **groups)
    after = collectives.COUNTS.snapshot()
    with open(os.path.join(out, f"{job['name']}_r{par.rank}.json"),
              "w") as f:
        json.dump({"warm": warm, "one": one, "comms": multi.comms,
                   "one_step": {k: after[k] - before[k] for k in after}}, f)


def trainer_job(par, job: dict, out: str) -> None:
    """The trainer on the ranks, 2 steps at steps_per_call 1 and at K,
    TensorBoard off; the leader's stdout kept."""
    trainer_mod.MetricWriter = functools.partial(plogging.MetricWriter,
                                                 use_tensorboard=False)
    for k in (1, K):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli._train(Config(**{
                **TRAINER_KW, "total_step": 2, "steps_per_call": k,
                "log_step": k, "model_save_step": 0,
                "out_dir": os.path.join(out, f"{job['name']}_k{k}")}), par)
        with open(os.path.join(out, f"{job['name']}_k{k}_r{par.rank}.out"),
                  "w") as f:
            f.write(buf.getvalue())


JOBS = {"multi": multi_job, "trainer": trainer_job}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two data ranks, then data 2 × time 2, running every job."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("parallel_k"))
    try:
        run_ranks(2, 1, [{"kind": "multi", "name": "dp"}], out, _rank_main)
        run_ranks(4, 2, [{"kind": "multi", "name": "dt"},
                         {"kind": "trainer", "name": "dt_trainer"}], out,
                  _rank_main)
    finally:
        torch.set_num_threads(n)
    return out


def multi_results(out: str, name: str, world: int) -> list[dict]:
    res = []
    for r in range(world):
        with open(os.path.join(out, f"{name}_r{r}.json")) as f:
            res.append(json.load(f))
    return res


@pytest.mark.parametrize("name,world", [("dp", 2), ("dt", 4)])
def test_warm_up_issues_one_steps_collectives(ranks, name, world):
    res = multi_results(ranks, name, world)
    for r in res:
        assert r["warm"] == r["one"]
        kinds = {c[0] for c in r["one"]}
        assert "all_reduce" in kinds
        # DT's halos and score sums: all-gathers under time sharding only
        assert ("all_gather" in kinds) == (name == "dt")
    # every rank issues the same calls in the same order and sizes
    shapes = [[c[:3] for c in r["one"]] for r in res]
    assert all(s == shapes[0] for s in shapes)


@pytest.mark.parametrize("name,world", [("dp", 2), ("dt", 4)])
def test_multi_step_counts_one_steps_collectives(ranks, name, world):
    for r in multi_results(ranks, name, world):
        assert r["comms"] == r["one_step"]
        assert min(r["comms"].values()) >= 0 and r["comms"]["bytes"] > 0


def test_trainer_comm_fields_at_k2_equal_those_at_k1(ranks):
    def comm_lines(k):
        with open(os.path.join(ranks, f"dt_trainer_k{k}_r0.out")) as f:
            lines = [plogging.parse_step_line(ln) for ln in f
                     if ln.startswith("step ")]
        return {s: {n: v for n, v in m.items() if n.startswith("comm_")}
                for s, m in lines}

    k1, k2 = comm_lines(1), comm_lines(K)
    assert sorted(k1) == [1, 2] and sorted(k2) == [2]
    assert set(k1[2]) == {"comm_all_reduce", "comm_all_gather",
                          "comm_bytes"}
    assert k1[1] == k1[2] == k2[2]
    assert min(k2[2].values()) > 0
    # the other ranks write no step line
    for r in range(1, 4):
        with open(os.path.join(ranks, f"dt_trainer_k{K}_r{r}.out")) as f:
            assert not [ln for ln in f if ln.startswith("step ")]


def test_a_rank_takes_its_share_of_the_hosts_cores(monkeypatch):
    got = []
    monkeypatch.setattr(pmesh.torch, "set_num_threads", got.append)
    monkeypatch.setattr(pmesh.os, "sched_getaffinity", lambda pid: range(32),
                        raising=False)
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    for ranks in (1, 4, 12, 64):
        pmesh.share_cores(ranks)
    assert got == [32, 8, 2, 1]
    monkeypatch.setenv("OMP_NUM_THREADS", "3")   # the launcher's choice
    pmesh.share_cores(4)
    assert got == [32, 8, 2, 1]


def test_nccl_is_captured_thread_local_and_barriers_on_the_ranks_card(
        monkeypatch):
    assert step.capture_mode() == "global"      # no process group
    monkeypatch.setattr(step.dist, "is_initialized", lambda: True)
    for backend, mode in (("gloo", "global"), ("nccl", "thread_local")):
        monkeypatch.setattr(step.dist, "get_backend", lambda g=None: backend)
        assert step.capture_mode() == mode
    calls = []
    monkeypatch.setattr(pmesh.dist, "barrier",
                        lambda **kw: calls.append(kw))
    for backend, device in (("nccl", torch.device("cuda", 2)),
                            ("gloo", torch.device("cpu"))):
        pmesh.Parallel(pmesh.Mesh((4,)), 2, device, backend, None,
                       None).barrier()
    assert calls == [{"device_ids": [2]}, {}]


def test_a_rate_reading_keeps_the_steady_intervals_of_either_mode(
        tmp_path, monkeypatch):
    """The four-card rates' readings (`chip_smoke.card_rates_rank`): one
    trainer read at steps_per_call 1 and then K by switching its
    `steps_per_call`, each reading's rate the trainer's own steps_per_sec
    of its logged intervals but the first (`chip_smoke.steady_ms`)."""
    from chip_smoke import steady_ms

    monkeypatch.setattr(trainer_mod, "MetricWriter", functools.partial(
        plogging.MetricWriter, use_tensorboard=False))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = trainer_mod.Trainer(Config(**{
            **TRAINER_KW, "total_step": 0, "steps_per_call": K,
            "log_step": K, "model_save_step": 0,
            "out_dir": str(tmp_path)}))
        logs = os.path.join(str(tmp_path), "logs")
        got = {}
        with contextlib.redirect_stdout(io.StringIO()):
            for kk in (1, K, 1, K):
                tr.steps_per_call = kk
                first = tr.start_step
                tr.train(total_step=first + 3 * K)
                got.setdefault(kk, []).append(
                    steady_ms(logs, first, first + 3 * K, K))
        assert tr.start_step == 12 * K and tr._multi is not None
    finally:
        torch.set_num_threads(n)
    for kk in (1, K):
        for ms in got[kk]:      # of 3 intervals, the last 2
            assert len(ms) == 2 and min(ms) > 0
    with open(os.path.join(logs, "scalars.jsonl")) as f:
        logged = [json.loads(ln)["step"] for ln in f
                  if '"steps_per_sec"' in ln]
    assert logged == list(range(K, 12 * K + 1, K))
