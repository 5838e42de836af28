"""The f32 conditioning behind the port's parallel tolerances, on the CPU
at the repo's test scale (img 32, T 4, ch 8, batch 4, d_steps 1).

    python tools/torch_parallel_conditioning.py     # from the repo root

Prints, as max |Adam mu difference| / max |mu| per model (mu is the
gradient: β1 = 0):

  1. two data ranks (gloo processes) against one process fed the same two
     groups' draws, one step from the seeded (orthogonal) init, from a
     state off it (`off_init`, as the CPU step tests and the smoke's f32
     checks start), and from the init with the state, clip and z in
     float64 (σ and BN moment math stay f32);
     and, off the init, with a planted fault in G's cross-replica BN
     (`test_torch_port_parallel.FAULTS`: each rank's own moments, or their
     all-reduce without its backward), the step G's DP limit must fail;
  2. from the reference's test state (`test_torch_port_fp.reference_state
     (3)`, the reference's two-group draws) the port's one process in f32
     and the reference's f32 step (`dvdgan_tpu`, jitted) each against the
     port's one process in float64, after one and after two steps.

  3. (`--bisect`) from that state, the port's float64 run with one module
     at a time computed in f32 (its inputs rounded to f32, its output cast
     back), against the port's float64 run after two steps: the convs
     (`layers.conv2d`, `conv3d`), the linear maps (`layers.linear`), the
     CBN affine, the BN normalization, the attention, Adam; and the
     port's f32 run. The module whose f32 alone gives the f32 run's gap
     carries it (σ, the BN moments and the GRU's plain version compute in
     f32 in both runs).

Parts 2 and 3 import JAX (a machine with the JAX package, as the tests);
part 1 needs torch alone.

    python tools/torch_parallel_conditioning.py --bisect    # part 3 alone
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from dvdgan_tpu_torch import interop  # noqa: E402
from dvdgan_tpu_torch.core import tree  # noqa: E402
from dvdgan_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dvdgan_tpu_torch.train import state as train_state  # noqa: E402
from dvdgan_tpu_torch.train import step  # noqa: E402
from chip_smoke import off_init  # noqa: E402
from dvdgan_tpu_torch.parallel import collectives  # noqa: E402
from test_torch_port_parallel import (B, FAULTS, G_KW, configs,  # noqa: E402
                                      mu_gaps, one_process)


def _double(state: dict) -> dict:
    return tree.tree_map(
        lambda v: v.double() if v.is_floating_point() else v, state)


def _rank(local_rank: int, state_path: str, batch_path: str, f64: bool,
          out: str, fault=None) -> None:
    """One of two data ranks: one step on its rows, its draws, its state
    written as an npz; `fault`: a planted fault of `FAULTS` by name."""
    torch.set_num_threads(1)
    if fault is not None:
        collectives.all_mean = FAULTS[fault]
    par = pmesh.init_from_env(torch.device("cpu"), 1, B, timeout_s=60)
    try:
        cfgs = configs({"g": G_KW})
        dtype = torch.float64 if f64 else torch.float32
        state = interop.load_train_state(dict(np.load(state_path)))
        state = _double(state) if f64 else state
        data = np.load(batch_path)
        lo, hi = pmesh.local_batch_rows(par.mesh, B, [par.rank])
        draws = step.TorchDraws(0, 0, hi - lo, cfgs[0].z_dim,
                                cfgs[0].n_frames, cfgs[1].k_frames, dtype,
                                "cpu", shard=pmesh.rank_shard(par))
        new, _ = pmesh.make_parallel_train_step(*cfgs, par)(
            state, torch.from_numpy(data["real"][0, lo:hi]).to(dtype),
            torch.from_numpy(data["y"][0, lo:hi]).long(), draws)
        np.savez(os.path.join(out, f"r{par.rank}.npz"),
                 **interop.train_state_to_flat(new))
    finally:
        par.close()


def two_ranks_vs_one(out: str, start: str, f64: bool = False,
                     fault=None) -> dict:
    cfgs = configs({"g": G_KW})
    state = train_state.create(1, *cfgs[:3])
    if start == "off_init":
        state = off_init(state, 2)
    state_path = os.path.join(out, f"{start}.npz")
    np.savez(state_path, **interop.train_state_to_flat(state))
    rng = np.random.RandomState(1)
    batch_path = os.path.join(out, "batch.npz")
    np.savez(batch_path, real=rng.uniform(-1, 1, (1, B, 4, 32, 32, 3))
             .astype(np.float32), y=(rng.permutation(B) % 5)[None])
    pmesh.spawn(_rank, 2, (state_path, batch_path, f64, out, fault),
                timeout_s=120)
    ranks = dict(np.load(os.path.join(out, "r0.npz")))
    dtype = torch.float64 if f64 else torch.float32
    draws = step.ShardedDraws(2, 0, 0, B, cfgs[0].z_dim, cfgs[0].n_frames,
                              cfgs[1].k_frames, dtype, "cpu")
    data = np.load(batch_path)
    one = _double(state) if f64 else state
    one, _ = step.train_step(one, torch.from_numpy(data["real"][0]).to(dtype),
                             torch.from_numpy(data["y"][0]).long(), draws,
                             *cfgs)
    return mu_gaps(interop.train_state_to_flat(one), ranks)


def reference_state_steps(out: str) -> dict:
    """Part 2: the port f32 and the reference f32 against the port f64."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from dvdgan_tpu.models import DSConfig as JDS
    from dvdgan_tpu.models import DTConfig as JDT
    from dvdgan_tpu.models import GConfig as JG
    from dvdgan_tpu.train import state as jstate
    from dvdgan_tpu.train import step as jstep
    import test_torch_port_time_shard as ts

    jstate0 = ts.reference_state(3, ts.G_KW, ts.DS_KW, ts.DT_KW, ts.TC_KW)
    state_path = os.path.join(out, "ref_state.npz")
    np.savez(state_path, **ts.flat_np(jstate0))
    rng = np.random.RandomState(7)
    real = rng.uniform(-1, 1, (2, B, 4, 32, 32, 3)).astype(np.float32)
    y = np.stack([rng.permutation(B) % 5 for _ in range(2)])
    batch_path = os.path.join(out, "ref_batch.npz")
    np.savez(batch_path, real=real, y=y.astype(np.int64))
    draws_path = os.path.join(out, "ref_draws.npz")
    ts.group_draws(draws_path)
    f = jax.jit(functools.partial(
        jstep.train_step, g_cfg=JG(**ts.G_KW), ds_cfg=JDS(**ts.DS_KW),
        dt_cfg=JDT(**ts.DT_KW), tc=jstate.TrainConfig(**ts.TC_KW),
        rng_shards=2))
    res, jst = {}, jstate0
    for steps in (1, 2):
        job = {"state": state_path, "batch": batch_path, "steps": steps,
               "g": ts.G_KW, "tc": ts.TC_KW, "draws": draws_path}
        s = steps - 1
        jst, _ = f(jst, jnp.asarray(real[s]), jnp.asarray(y[s]),
                   jax.random.PRNGKey(ts.KEY_SEED + s))
        f64 = _one_process_f64(job)
        f32, _ = one_process(job, 2)
        res[steps] = {"port_f32": mu_gaps(f64, f32),
                      "reference_f32": mu_gaps(f64, ts.flat_np(jst))}
    return res


def _one_process_f64(job: dict) -> dict:
    """`one_process` with the state, clip and z in float64."""
    cfgs = configs(job)
    state = _double(interop.load_train_state(dict(np.load(job["state"]))))
    data, a = np.load(job["batch"]), dict(np.load(job["draws"]))
    for s in range(job["steps"]):
        draws = step.HeldDraws(cfgs[3].d_steps, B, cfgs[0].z_dim,
                               cfgs[1].k_frames, torch.float64, "cpu")
        for kind, i in draws.order:
            buf = draws.zs[i] if kind == "z" else draws.ids[i]
            buf.copy_(torch.from_numpy(np.concatenate(
                [a[f"s{s}/g{g}/{kind}{i}"] for g in range(2)])))
        state, _ = step.train_step(
            state, torch.from_numpy(data["real"][s]).double(),
            torch.from_numpy(data["y"][s]).long(), draws, *cfgs)
    return {k: v.astype(np.float32)
            for k, v in interop.train_state_to_flat(state).items()}


def _in_f32(fn):
    """`fn` computed in f32 where its float64 tensor arguments (and those
    of its dict arguments) are rounded to f32; its output cast back."""
    def cast(v, dtype):
        return tree.tree_map(
            lambda x: x.to(dtype) if torch.is_tensor(x) and x.dtype in (
                torch.float32, torch.float64) else x, v)

    def wrapped(*args, **kwargs):
        leaves = tree.flatten_with_paths(list(args)).values()
        if not any(torch.is_tensor(a) and a.dtype == torch.float64
                   for a in leaves):
            return fn(*args, **kwargs)
        out = fn(*(cast(a, torch.float32) for a in args),
                 **{k: cast(v, torch.float32) for k, v in kwargs.items()})
        return cast(out, torch.float64)
    return wrapped


def _cbn_affine_in_f32(p, stats, x, cond, train, momentum=0.1, eps=1e-5,
                       group=None):
    """`norm.cbn` with its normalization in x's dtype and its affine
    (γ = 1 + W_g·cond, β, y·γ + β) in f32."""
    from dvdgan_tpu_torch.ops import layers, norm
    mean, var, new_stats = norm._select_moments(stats, x, train, momentum,
                                                group)
    y = norm._normalize(x, mean, var, eps).float()
    p32 = {k: {"w": v["w"].float()} for k, v in p.items()}
    gamma = 1.0 + layers.linear(p32["gamma"], cond.float())
    beta = layers.linear(p32["beta"], cond.float())
    y = y * gamma[:, None, None, :] + beta[:, None, None, :]
    return y.to(x.dtype), new_stats


def bisect(out: str) -> dict:
    """Part 3: G's mu after two steps from `reference_state(3)`, the port
    in float64 with one module at a time in f32, against the port in
    float64."""
    from unittest import mock

    import jax
    jax.config.update("jax_platforms", "cpu")
    from dvdgan_tpu_torch.ops import attention, layers, norm
    import test_torch_port_time_shard as ts

    jstate0 = ts.reference_state(3, ts.G_KW, ts.DS_KW, ts.DT_KW, ts.TC_KW)
    job = {"state": os.path.join(out, "ref_state.npz"),
           "batch": os.path.join(out, "ref_batch.npz"),
           "draws": os.path.join(out, "ref_draws.npz"),
           "steps": 2, "g": ts.G_KW, "tc": ts.TC_KW}
    np.savez(job["state"], **ts.flat_np(jstate0))
    rng = np.random.RandomState(7)
    np.savez(job["batch"],
             real=rng.uniform(-1, 1, (2, B, 4, 32, 32, 3)).astype(np.float32),
             y=np.stack([rng.permutation(B) % 5 for _ in range(2)]))
    ts.group_draws(job["draws"])
    f64 = _one_process_f64(job)
    f32 = one_process(job, 2)[0]
    keys = [k for k in f64 if k.startswith("g/opt/0/mu/")]
    scale = max(np.abs(f64[k]).max() for k in keys)
    gaps = {k: np.abs(f64[k] - f32[k]) / scale for k in keys}
    worst = max(gaps, key=lambda k: gaps[k].max())
    print(f"the f32 step's G mu gap: largest in {worst} "
          f"({gaps[worst].max():.2e}); elements over 1e-5 x max|mu|: "
          + ", ".join(f"{k} {int((v > 1e-5).sum())}/{v.size}"
                      for k, v in gaps.items() if (v > 1e-5).any()),
          flush=True)
    patches = {
        "convs": [(layers, "conv2d"), (layers, "conv3d")],
        "linear": [(layers, "linear")],
        "bn_normalize": [(norm, "_normalize")],
        "attention": [(attention, "spatial_attn"),
                      (attention, "temporal_attn")],
        "adam": [(train_state, "adam_update")]}
    res = {"f32 (the whole step)": mu_gaps(f64, f32)}
    # one at a time, all of them, all but one, and the convs (the one
    # whose absence closes the gap) with each other one
    runs = {name: [name] for name in (*patches, "cbn_affine")}
    runs["all six"] = list(runs)
    for left_out in runs["all six"]:
        runs[f"all but {left_out}"] = [n for n in runs["all six"]
                                       if n != left_out]
    for other in runs["all six"][1:]:
        runs[f"convs and {other}"] = ["convs", other]
    for run, names in runs.items():
        with contextlib.ExitStack() as stack:
            for name in names:
                if name == "cbn_affine":
                    stack.enter_context(mock.patch.object(
                        norm, "cbn", _cbn_affine_in_f32))
                    continue
                for mod, fn in patches[name]:
                    stack.enter_context(mock.patch.object(
                        mod, fn, _in_f32(getattr(mod, fn))))
            res[run] = mu_gaps(f64, _one_process_f64(job))
    return res


def main() -> None:
    os.environ.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    if "--bisect" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as out:
            for name, gaps in bisect(out).items():
                print(f"reference_state(3), 2 steps, {name} in f32 vs the "
                      f"port in float64: "
                      + ", ".join(f"{m} {v:.2e}" for m, v in gaps.items()),
                      flush=True)
        return
    with tempfile.TemporaryDirectory() as out:
        for start, f64 in (("init", False), ("off_init", False),
                           ("init", True)):
            gaps = two_ranks_vs_one(out, start, f64)
            print(f"two ranks vs one process, from the {start}"
                  f"{', float64' if f64 else ''}: "
                  + ", ".join(f"{m} {v:.2e}" for m, v in gaps.items()),
                  flush=True)
        for fault in sorted(FAULTS):
            gaps = two_ranks_vs_one(out, "off_init", fault=fault)
            print(f"two ranks with the fault {fault} vs one process, from "
                  f"the off_init: "
                  + ", ".join(f"{m} {v:.2e}" for m, v in gaps.items()),
                  flush=True)
        for steps, r in reference_state_steps(out).items():
            for who, gaps in r.items():
                print(f"reference_state(3), {steps} step(s), {who} vs the "
                      f"port in float64: "
                      + ", ".join(f"{m} {v:.2e}" for m, v in gaps.items()),
                      flush=True)


if __name__ == "__main__":
    main()
