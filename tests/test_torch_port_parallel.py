"""Data and time parallelism of the port (`parallel/`, the `group` and
`time_group` of `train/step.py`, the trainer's ranks), on the CPU at the
repo's test scale (img 32, T 4, ch 8, f32), with ranks as gloo processes
(`parallel.mesh.spawn`), each on one torch and one OpenBLAS thread, the
process group's collectives cut at `COLLECTIVE_TIMEOUT_S` and the launch at
`LAUNCH_TIMEOUT_S`, so that a hang fails instead of stalling the suite.
Every multi-rank test holds the ranks' replicas bitwise equal.

This file imports no JAX: the ranks unpickle their jobs from it by name, so
a rank starts with torch alone. `test_torch_port_time_shard.py` holds the
ranks against the JAX package through the same jobs. Here, port against
port:

  * two data ranks (`--n_devices 2`'s mesh) against one process fed the
    same two groups' draws (`step.ShardedDraws`), 2 steps from a state off
    its init (`chip_smoke.off_init`): DS's and DT's Adam mu within 1e-5 ×
    max|mu|, G's within 1e-4 (its f32 gradient over two ranks moves with
    the state: 1.1e-7 to 4.4e-5 of one process's, `tools/
    torch_parallel_conditioning.py`), losses within 1e-4; and that G limit
    fails a step with a planted fault in its cross-replica BN (each rank's
    own moments, or an all-reduce of them without its backward);
  * (data 2 × time 2) against data 2 alone (the reference's
    `test_time_cp_step_matches_data_parallel_only` contract) and the same
    for DVD-GAN-FP (cond_frames 2 + n_frames 2, split over 2 time ranks):
    losses 1e-4, DS's and DT's Adam mu within 1e-5 × max|mu|, G's within
    1e-4 (as above);
  * collectives: `all_mean`'s gradient is the gradient of the ranks'
    summed losses (the reference's pmean transpose), the halos against the
    neighbours' frames and their cotangents sent back, a group of one
    rank keeps `train_step`'s bits;
  * remat with cross-replica BN: every rank issues the same all-reduces a
    step, more than without remat (a replayed region issues its CBNs'
    again), and the state equals the step without remat bitwise;
  * `local_batch_rows` on 1-D and 2-D layouts with its contiguity error,
    and `Loader(rows=)` against a sliced global batch;
  * the trainer on two ranks: resumed at step 2 it has the uninterrupted
    run's bits at 4, and `--steps_per_call 2` (eager on the CPU) equals the
    four single steps;
  * the CLI's launch rule (`parallel.mesh.plan`), `--n_devices 2 --device
    cpu` spawning its ranks, and `MultiStep` refusing a CUDA group.
"""

from __future__ import annotations

import functools
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import off_init
from dvdgan_tpu_torch import cli, interop
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.data import Loader, SyntheticVideoDataset
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig
from dvdgan_tpu_torch.ops import norm, resize
from dvdgan_tpu_torch.parallel import collectives
from dvdgan_tpu_torch.parallel import mesh as pmesh
from dvdgan_tpu_torch.parallel import time_shard
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging
from dvdgan_tpu_torch.utils.config import Config

COLLECTIVE_TIMEOUT_S = 60.0
LAUNCH_TIMEOUT_S = 120.0
G_KW = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16)
FP_G_KW = {**G_KW, "n_frames": 2, "cond_frames": 2}
DS_KW = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
DT_KW = dict(img_size=32, n_frames=4, ch=8, n_classes=5)
TC_KW = dict(d_steps=1, ema_start=0)
B = 4                       # the global batch
LOSSES = ("d_loss", "d_loss_s", "d_loss_t", "g_loss")
TRAINER_KW = dict(dataset="synthetic", n_classes=5, img_size=32, n_frames=4,
                  ch=8, d_ch=8, emb_dim=16, attn_res=16, k_frames=2,
                  batch_size=B, d_steps=1, bf16=False, ema_start=0, seed=5,
                  device="cpu", log_step=1, sample_step=0, loader_threads=1)


# ------------------------------------------------------------- the ranks --
def run_ranks(world: int, n_time: int, jobs: list[dict], out: str,
              main=None) -> None:
    """Runs `jobs` in order on `world` gloo ranks (data world/n_time ×
    time n_time), one torch and one OpenBLAS thread each; each job writes
    its results under `out`. `main(local_rank, n_time, jobs, out)` runs in
    each rank (default `_rank_main`, this file's jobs)."""
    env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                          "OPENBLAS_NUM_THREADS")}
    os.environ.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    try:
        pmesh.spawn(main or _rank_main, world, (n_time, jobs, out),
                    timeout_s=LAUNCH_TIMEOUT_S)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(local_rank: int, n_time: int, jobs: list[dict], out: str):
    torch.set_num_threads(1)
    par = pmesh.init_from_env(torch.device("cpu"), n_time, B,
                              timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        for job in jobs:
            JOBS[job["kind"]](par, job, out)
    finally:
        par.close()


def configs(job: dict) -> tuple:
    return (GConfig(**job["g"]), DSConfig(**job.get("ds", DS_KW)),
            DTConfig(**job.get("dt", DT_KW)),
            train_state.TrainConfig(**job.get("tc", TC_KW)))


class Replay:
    """Draws by stream from an npz: z<stream> and idx<stream>."""

    def __init__(self, arrays: dict, prefix: str):
        self.a, self.prefix = arrays, prefix

    def z(self, i):
        return torch.from_numpy(self.a[f"{self.prefix}z{i}"])

    def idx(self, i):
        return torch.from_numpy(self.a[f"{self.prefix}idx{i}"]).long()


def rank_draws(job: dict, s: int, rows: int, shard, g_cfg, ds_cfg):
    """Step s's draws of a rank: its `TorchDraws`, or with job["draws"]
    (an npz path) the arrays of its data group g, keys s<s>/g<g>/…"""
    if "draws" not in job:
        return step.TorchDraws(job.get("seed", 0), s, rows, g_cfg.z_dim,
                               g_cfg.n_frames, ds_cfg.k_frames,
                               torch.float32, "cpu", shard=shard)
    return Replay(dict(np.load(job["draws"])), f"s{s}/g{shard or 0}/")


def _no_cross_replica_moments(x: torch.Tensor, group) -> torch.Tensor:
    """A planted fault of `all_mean` (G's BN moments): each rank's own."""
    return x


def _all_mean_without_backward(x: torch.Tensor, group) -> torch.Tensor:
    """A planted fault of `all_mean`: the mean over the ranks forward, as a
    plain `dist.all_reduce` gives it, and the local term alone backward."""
    return x + (collectives._all_reduce(x, group, True) - x).detach()


FAULTS = {"local_bn": _no_cross_replica_moments,
          "detached_bn": _all_mean_without_backward}


def step_job(par, job: dict, out: str) -> None:
    """job: g/ds/dt/tc kwargs, state (npz of a flat train state), batch
    (npz: real (S, B, T, H, W, 3), y (S, B)), steps S, draws, and a planted
    fault of `FAULTS` by name. Writes the rank's state, per-step metrics
    and collective counts."""
    if "fault" in job:
        right = collectives.all_mean
        collectives.all_mean = FAULTS[job["fault"]]
        try:
            return step_job(par, {k: v for k, v in job.items()
                                  if k != "fault"}, out)
        finally:
            collectives.all_mean = right
    cfgs = configs(job)
    state = interop.load_train_state(dict(np.load(job["state"])))
    state = pmesh.replicate_state(state, par)
    data = np.load(job["batch"])
    lo, hi = pmesh.local_batch_rows(par.mesh, B, [par.rank])
    f = pmesh.make_parallel_train_step(*cfgs, par)
    res = {}
    for s in range(job["steps"]):
        before = collectives.COUNTS.snapshot()
        draws = rank_draws(job, s, hi - lo, pmesh.rank_shard(par), *cfgs[:2])
        state, m = f(state, torch.from_numpy(data["real"][s, lo:hi]),
                     torch.from_numpy(data["y"][s, lo:hi]).long(), draws)
        after = collectives.COUNTS.snapshot()
        res.update({f"m{s}/{k}": v.numpy() for k, v in m.items()})
        res.update({f"c{s}/{k}": after[k] - before[k] for k in after})
    res.update({f"state/{k}": v
                for k, v in interop.train_state_to_flat(state).items()})
    np.savez(os.path.join(out, f"{job['name']}_r{par.rank}.npz"), **res)


def collectives_job(par, job: dict, out: str) -> None:
    """all_mean's moments and gradient, the halos and their cotangents, on
    rows/frames of arrays drawn from a seed; a group of one rank against
    group=None."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2 * 3, 5, 5, 4).astype(np.float32))
    a, b = (torch.from_numpy(rng.randn(4).astype(np.float32))
            for _ in range(2))
    lo, hi = 3 * par.rank, 3 * (par.rank + 1)
    xr = x[lo:hi].clone().requires_grad_(True)
    mean, var = norm._batch_moments(xr, par.data_group)
    ((mean * a).sum() + (var * b).sum()).backward()
    # halos over a clip split in two along time
    clip = torch.from_numpy(rng.randn(2, 6, 3, 3, 2).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 3, 3, 2).astype(np.float32))
    part = clip[:, 3 * par.rank:3 * (par.rank + 1)].clone()
    part.requires_grad_(True)
    left, right = collectives.halos(part, dist.group.WORLD)
    ((left * w).sum() + 2 * (right * w).sum()).backward()
    res = {"mean": mean.detach().numpy(), "var": var.detach().numpy(),
           "dx": xr.grad.numpy(), "left": left.detach().numpy(),
           "right": right.detach().numpy(), "dpart": part.grad.numpy()}
    # a group of one rank: no call, today's bits
    ones = [dist.new_group([r]) for r in range(dist.get_world_size())]
    mine = ones[par.rank]
    cfgs = configs({"g": G_KW})
    state = train_state.create(3, *cfgs[:3])
    real = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 32, 32, 3))
                            .astype(np.float32))
    y = torch.arange(2) % 5
    runs = []
    for groups in ({}, {"group": mine, "time_group": mine}):
        before = collectives.COUNTS.snapshot()
        new, _ = step.train_step(state, real, y, step.TorchDraws(
            0, 0, 2, 120, 4, 2, torch.float32, "cpu"), *cfgs, **groups)
        assert collectives.COUNTS.snapshot() == before
        runs.append(interop.train_state_to_flat(new))
    res["one_rank_equal"] = np.array(all(
        np.array_equal(v, runs[1][k]) for k, v in runs[0].items()))
    np.savez(os.path.join(out, f"collectives_r{par.rank}.npz"), **res)


def trainer_job(par, job: dict, out: str) -> None:
    """Trainer runs on the ranks (`cli.train_rank`'s body, TensorBoard
    off): A to step 4 with checkpoints at 2 and 4; B resumed from a copy of
    A's step-2 checkpoint, to 4; K, 4 steps at steps_per_call 2."""
    import torch.distributed as dist
    trainer_mod.MetricWriter = functools.partial(plogging.MetricWriter,
                                                 use_tensorboard=False)
    def run(**kw):
        cli._train(Config(**{**TRAINER_KW, "total_step": 4, **kw}), par)

    a = os.path.join(out, "trainer_A")
    run(model_save_step=2, out_dir=a)
    b = os.path.join(out, "trainer_B")
    if par.is_main:
        shutil.copytree(os.path.join(a, "checkpoints", "2"),
                        os.path.join(b, "checkpoints", "2"))
    dist.barrier()
    run(model_save_step=4, out_dir=b)
    run(model_save_step=4, steps_per_call=2, log_step=2,
        out_dir=os.path.join(out, "trainer_K"))


def dt_job(par, job: dict, out: str) -> None:
    """The time-sharded DT over the world's ranks: job["params"] (npz of DT
    params by path), job["clip"] (npz: clip, y); writes the scores and the
    gradient of their sum with respect to the params."""
    params = tree.unflatten({k: torch.from_numpy(v) for k, v in
                             np.load(job["params"]).items()})
    data = np.load(job["clip"])
    cfg = DTConfig(**job["dt"])
    leaves = tree.tree_map(lambda p: p.requires_grad_(True), params)
    f = time_shard.make_sharded_dt(leaves, cfg, dist.group.WORLD)
    scores = f(torch.from_numpy(data["clip"]),
               torch.from_numpy(data["y"]).long())
    flat = tree.flatten_with_paths(leaves)
    grads = torch.autograd.grad(scores.sum(), list(flat.values()))
    np.savez(os.path.join(out, f"dt_r{par.rank}.npz"),
             scores=scores.detach().numpy(),
             **{f"grad/{k}": g.numpy() for k, g in zip(flat, grads)})


JOBS = {"step": step_job, "collectives": collectives_job,
        "trainer": trainer_job, "dt": dt_job}


def rank_results(out: str, name: str, world: int) -> list[dict]:
    res = [dict(np.load(os.path.join(out, f"{name}_r{r}.npz")))
           for r in range(world)]
    for r in res[1:]:               # the replicas: bitwise equal
        for k, v in res[0].items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(v, r[k], err_msg=k)
    return res


# -------------------------------------------------------------- the inputs --
def write_inputs(out: str, g_kw: dict, seed: int, steps: int,
                 dt_kw=DT_KW) -> dict:
    """A seeded train state off its init (`off_init`) and `steps` batches
    in npz files; -> the step job's fields."""
    cfgs = configs({"g": g_kw, "dt": dt_kw})
    state = off_init(train_state.create(seed, *cfgs[:3]), seed + 1)
    st = os.path.join(out, f"state_{seed}.npz")
    np.savez(st, **interop.train_state_to_flat(state))
    rng = np.random.RandomState(seed)
    t = dt_kw["n_frames"]
    real = rng.uniform(-1, 1, (steps, B, t, 32, 32, 3)).astype(np.float32)
    y = np.stack([rng.permutation(B) % 5 for _ in range(steps)])
    bt = os.path.join(out, f"batch_{seed}.npz")
    np.savez(bt, real=real, y=y.astype(np.int64))
    return {"state": st, "batch": bt, "steps": steps, "g": g_kw,
            "dt": dt_kw}


def one_process(job: dict, r: int) -> tuple[dict, list[dict]]:
    """The job's steps in this process at the whole batch, fed the r data
    groups' draws (`ShardedDraws`, or the job's arrays concatenated)."""
    cfgs = configs(job)
    state = interop.load_train_state(dict(np.load(job["state"])))
    data = np.load(job["batch"])
    metrics = []
    for s in range(job["steps"]):
        if "draws" in job:
            a = dict(np.load(job["draws"]))
            draws = step.HeldDraws(cfgs[3].d_steps, B, cfgs[0].z_dim,
                                   cfgs[1].k_frames, torch.float32, "cpu")
            for kind, i in draws.order:
                parts = [a[f"s{s}/g{g}/{kind}{i}"] for g in range(r)]
                buf = draws.zs[i] if kind == "z" else draws.ids[i]
                buf.copy_(torch.from_numpy(np.concatenate(parts)))
        else:
            draws = step.ShardedDraws(r, job.get("seed", 0), s, B,
                                      cfgs[0].z_dim, cfgs[0].n_frames, cfgs[1].k_frames,
                                      torch.float32, "cpu")
        state, m = step.train_step(
            state, torch.from_numpy(data["real"][s]),
            torch.from_numpy(data["y"][s]).long(), draws, *cfgs)
        metrics.append({k: float(v) for k, v in m.items()})
    return interop.train_state_to_flat(state), metrics


def mu_gaps(ref: dict, got: dict) -> dict[str, float]:
    """Per model: max |Adam mu difference| / max |mu| (mu is the gradient
    at β1 = 0)."""
    out = {}
    for m in ("g", "ds", "dt"):
        keys = [k for k in ref if k.startswith(f"{m}/opt/0/mu/")]
        scale = max(np.abs(ref[k]).max() for k in keys)
        out[m] = max(np.abs(ref[k] - got[k]).max() for k in keys) / scale
    return out


def state_of(res: dict) -> dict:
    return {k[len("state/"):]: v for k, v in res.items()
            if k.startswith("state/")}


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, one_torch_thread):
    """One launch of two data ranks running every two-rank job."""
    out = str(tmp_path_factory.mktemp("two_ranks"))
    jobs = {
        "dp": write_inputs(out, G_KW, 1, 2),
        "dp1": write_inputs(out, G_KW, 2, 1),
        "fp1": write_inputs(out, FP_G_KW, 4, 1),
    }
    jobs["remat_off"] = dict(jobs["dp1"])
    for fault in FAULTS:
        jobs[f"fault_{fault}"] = {**jobs["dp1"], "fault": fault}
    jobs["remat_on"] = {**jobs["dp1"], "g": {**G_KW, "remat": True}}
    jobs = [{"kind": "step", "name": name, **job}
            for name, job in jobs.items()]
    run_ranks(2, 1, jobs + [{"kind": "collectives"}, {"kind": "trainer"}],
              out)
    return out, {j["name"]: j for j in jobs}


@pytest.fixture(scope="module")
def four_ranks(two_ranks):
    """(data 2 × time 2) on the inputs of the two-rank one-step jobs."""
    out, jobs = two_ranks
    cp = [{**jobs[n], "name": f"cp_{n}"} for n in ("dp1", "fp1")]
    run_ranks(4, 2, cp, out)
    return out, jobs


# ------------------------------------------------------------------- tests --
def test_two_data_ranks_match_one_process_fed_their_draws(two_ranks):
    out, jobs = two_ranks
    res = rank_results(out, "dp", 2)[0]
    ref, metrics = one_process(jobs["dp"], 2)
    got = state_of(res)
    gaps = mu_gaps(ref, got)
    assert gaps["ds"] <= 1e-5 and gaps["dt"] <= 1e-5, gaps
    assert gaps["g"] <= 1e-4, gaps
    for s, m in enumerate(metrics):
        for k in LOSSES:
            assert abs(m[k] - float(res[f"m{s}/{k}"])) <= 1e-4, (s, k)
    assert int(got["step"]) == 2


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_g_limit_fails_a_planted_cross_replica_bn_fault(two_ranks,
                                                            fault):
    """G's Adam mu limit under DP (1e-4 × max|mu|, here and on the card)
    holds the right step and fails one whose BN moments skip the other
    rank, or skip it in the backward alone."""
    out, jobs = two_ranks
    ref, _ = one_process(jobs["dp1"], 2)
    right = mu_gaps(ref, state_of(rank_results(out, "dp1", 2)[0]))
    with np.load(os.path.join(out, f"fault_{fault}_r0.npz")) as f:
        wrong = mu_gaps(ref, state_of(dict(f)))
    assert right["g"] <= 1e-4 < wrong["g"], (right, wrong)


@pytest.mark.parametrize("name", ["dp1", "fp1"])
def test_time_sharded_step_matches_data_parallel_only(four_ranks, name):
    out, _ = four_ranks
    dp = rank_results(out, name, 2)[0]
    cp = rank_results(out, f"cp_{name}", 4)
    for k in LOSSES:
        assert abs(float(dp[f"m0/{k}"]) - float(cp[0][f"m0/{k}"])) <= 1e-4
    gaps = mu_gaps(state_of(dp), state_of(cp[0]))
    assert gaps["ds"] <= 1e-5 and gaps["dt"] <= 1e-5, gaps
    assert gaps["g"] <= 1e-4, gaps
    # DT's halos and score sum ran: all-gathers on every rank
    assert all(int(r["c0/all_gather"]) > 0 for r in cp)
    assert int(dp["c0/all_gather"]) == 0


def test_all_mean_gradient_is_the_summed_losses_gradient(two_ranks):
    out, _ = two_ranks
    res = [dict(np.load(os.path.join(out, f"collectives_r{r}.npz")))
           for r in range(2)]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(6, 5, 5, 4).astype(np.float32))
    a, b = (torch.from_numpy(rng.randn(4).astype(np.float32))
            for _ in range(2))
    x.requires_grad_(True)
    mean, var = norm._batch_moments(x)
    ((mean * a).sum() + (var * b).sum()).backward()
    for r in res:
        np.testing.assert_allclose(r["mean"], mean.detach(), atol=1e-6)
        np.testing.assert_allclose(r["var"], var.detach(), atol=1e-6)
    # each rank's loss is the whole batch's: the gradient of the two
    # ranks' losses summed is twice the one-process gradient
    dx = np.concatenate([r["dx"] for r in res])
    np.testing.assert_allclose(dx, 2 * x.grad.numpy(), atol=1e-6, rtol=1e-5)


def test_halos_are_the_neighbours_frames_and_send_cotangents_back(two_ranks):
    out, _ = two_ranks
    res = [dict(np.load(os.path.join(out, f"collectives_r{r}.npz")))
           for r in range(2)]
    rng = np.random.RandomState(0)      # the job's draws, in its order
    rng.randn(6, 5, 5, 4), rng.randn(4), rng.randn(4)
    clip = rng.randn(2, 6, 3, 3, 2).astype(np.float32)
    w = rng.randn(2, 3, 3, 2).astype(np.float32)
    zero = np.zeros_like(clip[:, 0])
    np.testing.assert_array_equal(res[0]["left"], zero)
    np.testing.assert_array_equal(res[0]["right"], clip[:, 3])
    np.testing.assert_array_equal(res[1]["left"], clip[:, 2])
    np.testing.assert_array_equal(res[1]["right"], zero)
    # rank 1 took frame 2 as its left halo (cotangent w), rank 0 frame 3
    # as its right halo (cotangent 2w)
    want = np.zeros((2, 6, 3, 3, 2), np.float32)
    want[:, 2] = w
    want[:, 3] = 2 * w
    np.testing.assert_array_equal(
        np.concatenate([res[0]["dpart"], res[1]["dpart"]], axis=1), want)


def test_a_group_of_one_rank_keeps_the_one_process_bits(two_ranks):
    out, _ = two_ranks
    for r in range(2):
        res = np.load(os.path.join(out, f"collectives_r{r}.npz"))
        assert bool(res["one_rank_equal"])
    assert step.step_seed(7, 3) == step.step_seed(7, 3, None)
    assert step.step_seed(7, 3, 0) != step.step_seed(7, 3)


def test_remat_reissues_the_same_collectives_and_keeps_the_bits(two_ranks):
    out, _ = two_ranks
    off = rank_results(out, "remat_off", 2)
    on = rank_results(out, "remat_on", 2)
    counts = [int(r["c0/all_reduce"]) for r in on]
    assert counts[0] == counts[1] > int(off[0]["c0/all_reduce"])
    assert int(off[0]["c0/all_reduce"]) == int(off[1]["c0/all_reduce"])
    a, b = state_of(off[0]), state_of(on[0])
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k], err_msg=k)


def test_local_batch_rows_on_1d_and_2d_layouts():
    b = 8
    one = pmesh.Mesh((8,))
    two = pmesh.Mesh((2, 4), (pmesh.TIME_AXIS, pmesh.DATA_AXIS))
    for m in (one, two):
        assert pmesh.local_batch_rows(m, b, range(m.world)) == (0, b)
    assert pmesh.local_batch_rows(one, b, [3]) == (3, 4)
    # time outermost: rank r holds data index r % 4, 2 rows each
    assert pmesh.local_batch_rows(two, b, [5]) == (2, 4)
    assert pmesh.local_batch_rows(two, b, [1, 5]) == (2, 4)
    # data 2 × time 2, time innermost (the trainer's): ranks 2, 3 share
    dt = pmesh.Mesh((2, 2), (pmesh.DATA_AXIS, pmesh.TIME_AXIS))
    assert [pmesh.local_batch_rows(dt, 4, [r]) for r in range(4)] == [
        (0, 2), (0, 2), (2, 4), (2, 4)]
    assert dt.groups_along(pmesh.TIME_AXIS) == [[0, 1], [2, 3]]
    assert dt.groups_along(pmesh.DATA_AXIS) == [[0, 2], [1, 3]]
    with pytest.raises(ValueError, match="not contiguous"):
        pmesh.local_batch_rows(one, b, [1, 3])
    with pytest.raises(ValueError, match="does not split"):
        pmesh.local_batch_rows(pmesh.Mesh((3,)), b, [0])


def test_loader_rows_decode_a_slice_of_the_global_batch():
    ds = SyntheticVideoDataset(n_items=16, n_frames=2, img_size=8,
                               n_classes=3, seed=1)
    whole = Loader(ds, 4, seed=2, num_threads=1)
    part = Loader(ds, 4, seed=2, num_threads=1, rows=(2, 4))
    for (c, y), (cp, yp) in zip(whole.epoch(1), part.epoch(1)):
        np.testing.assert_array_equal(c[2:4], cp)
        np.testing.assert_array_equal(y[2:4], yp)
    with pytest.raises(ValueError):
        Loader(ds, 4, rows=(3, 5))


def test_trainer_on_two_ranks_resumes_and_steps_k_at_a_call(two_ranks):
    out, _ = two_ranks

    def final(run):
        path = os.path.join(out, run, "checkpoints", "4", "train_state.npz")
        with np.load(path) as f:
            return {k: f[k] for k in f.files}

    a = final("trainer_A")
    assert int(a["step"]) == 4
    for run in ("trainer_B", "trainer_K"):
        other = final(run)
        assert other.keys() == a.keys()
        for k, v in a.items():
            np.testing.assert_array_equal(v, other[k], err_msg=f"{run} {k}")
    # the leader alone wrote: scalars of every step of A
    with open(os.path.join(out, "trainer_A", "logs", "scalars.jsonl")) as f:
        steps = {int(ln.split('"step": ')[1].split(",")[0]) for ln in f}
    assert steps == {1, 2, 3, 4}


def test_window_of_the_pooled_clip_is_the_pooled_window():
    """φ is per frame: the D phase's pre-pool stays under time sharding."""
    clip = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (2, 8, 16, 16, 3)).astype(np.float32))
    for lo, hi in ((0, 4), (4, 8)):
        assert torch.equal(resize.avg_pool_2x_video(clip)[:, lo:hi],
                           resize.avg_pool_2x_video(clip[:, lo:hi]))


def test_a_multihost_rank_takes_the_card_of_its_local_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    assert pmesh.rank_device(cuda, 2) == torch.device("cuda", 2)
    # a named card is shared; the CPU stays the CPU
    assert pmesh.rank_device(torch.device("cuda", 0), 3) == torch.device(
        "cuda", 0)
    assert pmesh.rank_device(torch.device("cpu"), 3) == torch.device("cpu")
    with pytest.raises(ValueError, match="no card of its own"):
        pmesh.rank_device(cuda, 4)


def test_launch_plan_follows_the_reference_rule():
    cpu = torch.device("cpu")
    assert pmesh.plan(0, 1, 8, cpu) == (1, 1)
    assert pmesh.plan(2, 1, 8, cpu) == (2, 1)
    assert pmesh.plan(4, 2, 8, cpu) == (2, 2)
    assert pmesh.plan(3, 1, 8, cpu) == (2, 1)     # shrinks to divide 8
    with pytest.raises(ValueError, match="needs at least"):
        pmesh.plan(0, 2, 8, cpu)
    assert pmesh.choose_backend(["cpu", "cpu"])[0] == "gloo"
    assert pmesh.choose_backend(["h/GPU-a", "h/GPU-a"])[0] == "gloo"
    assert pmesh.choose_backend(["h/GPU-a", "h/GPU-b"])[0] == "nccl"
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.check_clip(GConfig(**G_KW), 3)


def test_sharded_draws_are_the_ranks_draws_in_rank_order():
    parts = [step.TorchDraws(1, 2, 2, 8, 4, 2, torch.float32, "cpu",
                             shard=g) for g in range(2)]
    both = step.ShardedDraws(2, 1, 2, 4, 8, 4, 2, torch.float32, "cpu")
    for kind, s in step.draw_order(1):
        want = torch.cat([getattr(p, kind)(s) for p in parts])
        assert torch.equal(getattr(both, kind)(s), want)


def test_cli_spawns_two_cpu_ranks(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(pmesh, "spawn",
                        lambda fn, world, args: calls.append((fn, world)))
    flags = ["--mode", "train", "--device", "cpu", "--img_size", "32",
             "--n_frames", "4", "--ch", "8", "--d_ch", "8", "--k_frames",
             "2", "--attn_res", "16", "--batch_size", "4", "--out_dir",
             str(tmp_path)]
    assert cli.main(flags + ["--n_devices", "2"]) is None
    assert cli.main(flags + ["--n_devices", "4", "--time_shards", "2"]) is None
    assert calls == [(cli.train_rank, 2), (cli.train_rank, 4)]
    with pytest.raises(ValueError, match="launcher starts"):
        cli.main(flags + ["--n_devices", "2", "--multihost", "1"])
    with pytest.raises(ValueError, match="one process"):
        cli.main(["--mode", "sample", "--device", "cpu", "--time_shards",
                  "2"])


def test_multi_step_refuses_a_group_on_cuda(monkeypatch):
    monkeypatch.setattr(collectives, "size", lambda g: 2)
    monkeypatch.setattr(step.dist, "get_backend", lambda g: "gloo")
    cfgs = configs({"g": G_KW})
    with pytest.raises(NotImplementedError, match="CUDA graph cannot"):
        step.MultiStep({}, 2, 2, *cfgs, 0, torch.float32, "cuda",
                       group=object())
