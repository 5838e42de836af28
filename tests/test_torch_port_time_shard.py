"""The port's data and time parallelism against the JAX package's, with the
port's ranks as gloo processes (`test_torch_port_parallel.run_ranks`: one
torch and one OpenBLAS thread a rank, collectives cut at 60 s, the launch
at 120 s) and the reference under `shard_map` on the conftest's CPU
devices or on one device; f32, JAX at `highest` matmul precision:

  * cross-replica BN moments on 2 ranks against the reference's
    `norm._batch_moments(axis_name="data")` under `shard_map` on 2
    devices, atol 1e-6;
  * the port's 2-rank data-parallel step against the reference's
    `train_step(rng_shards=2)` on one device, fed the reference's
    per-group draws (`fold_in(key, g)`), 2 steps from a state off its
    init: the losses within 1e-3 (the reference's own DP test's), DS and
    DT (params, Adam mu and nu) within 1e-5 × max|leaf kind| of their
    model, G's Adam mu within 5e-4 × max|mu| (below), the ranks' replicas bitwise equal, and the ranks' mu within the
    limits of `test_torch_port_parallel.py` of the port's one process fed
    the same draws (DS, DT 1e-5 × max|mu|, G 1e-4). G's 5e-4 against the
    reference is the port's own f32 at this state's second step, which
    lies 3.5e-4 × max|mu| off the port run in float64 (the reference's
    1.4e-6; 3.7e-7 and 1.7e-5 after the first step:
    `tools/torch_parallel_conditioning.py`, ROADMAP Queue 3);
  * `dt_apply_time_sharded` on 2 ranks against the reference's
    `make_sharded_dt` on a 2-device time mesh (T 8, ch 8): the scores
    within 1e-5 × max|score|, the parameter gradient (the mean of the
    ranks', as the step's gradient mean takes it) within 1e-5 × max|grad|.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dvdgan_tpu import parallel as jparallel
from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.models import discriminator as jdisc
from dvdgan_tpu.ops import norm as jnorm
from dvdgan_tpu.parallel import time_shard as jtime_shard
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.train import step as jstep
from test_torch_port_fp import ReferenceDraws, flat_np, reference_state
from test_torch_port_parallel import (B, DS_KW, DT_KW, G_KW, LOSSES, mu_gaps,
                                      one_process, rank_results, run_ranks,
                                      state_of)
from test_torch_port_parallel import one_torch_thread  # noqa: F401 fixture

TC_KW = dict(d_steps=1, ema_start=0)
DT_SHARD_KW = dict(img_size=32, n_frames=8, ch=8, n_classes=5)
STEPS = 2
KEY_SEED = 11


def reference_steps(jstate0, real, y):
    """The reference's `rng_shards=2` steps on one device; -> (flat state,
    per-step metrics)."""
    f = jax.jit(functools.partial(
        jstep.train_step, g_cfg=JGConfig(**G_KW), ds_cfg=JDSConfig(**DS_KW),
        dt_cfg=JDTConfig(**DT_KW), tc=jstate.TrainConfig(**TC_KW),
        rng_shards=2))
    st, metrics = jstate0, []
    for s in range(STEPS):
        st, m = f(st, jnp.asarray(real[s]), jnp.asarray(y[s]),
                  jax.random.PRNGKey(KEY_SEED + s))
        metrics.append({k: float(v) for k, v in m.items()})
    return flat_np(st), metrics


def group_draws(path: str) -> None:
    """The reference's per-group draws of every step into an npz, keyed
    s<step>/g<group>/z<stream> and idx<stream>."""
    out = {}
    n = 3 * TC_KW["d_steps"] + 2
    for s in range(STEPS):
        for g in range(2):
            d = ReferenceDraws(jax.random.fold_in(
                jax.random.PRNGKey(KEY_SEED + s), g), B // 2, G_KW["z_dim"],
                G_KW["n_frames"], DS_KW["k_frames"], TC_KW["d_steps"])
            for i in range(n):
                out[f"s{s}/g{g}/{'z' if i % 3 == 0 else 'idx'}{i}"] = (
                    (d.z(i) if i % 3 == 0 else d.idx(i)).numpy())
    # the G phase's z sits at stream 3·d_steps, a multiple of 3 as well
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, one_torch_thread):
    """One launch of 2 ranks: the moments, the reference-fed DP step and
    the time-sharded DT. -> (out dir, the inputs)."""
    out = str(tmp_path_factory.mktemp("time_shard"))
    jstate0 = reference_state(3, G_KW, DS_KW, DT_KW, TC_KW)
    st = os.path.join(out, "state.npz")
    np.savez(st, **flat_np(jstate0))
    rng = np.random.RandomState(7)
    real = rng.uniform(-1, 1, (STEPS, B, 4, 32, 32, 3)).astype(np.float32)
    y = np.stack([rng.permutation(B) % 5 for _ in range(STEPS)])
    bt = os.path.join(out, "batch.npz")
    np.savez(bt, real=real, y=y.astype(np.int64))
    dr = os.path.join(out, "draws.npz")
    group_draws(dr)
    params = jdisc.dt_init(jax.random.PRNGKey(0), JDTConfig(**DT_SHARD_KW))
    pp = os.path.join(out, "dt_params.npz")
    np.savez(pp, **flat_np(params))
    clip = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (2, 8, 32, 32, 3)))
    cp = os.path.join(out, "clip.npz")
    np.savez(cp, clip=clip, y=np.array([2, 4]))
    dp = {"kind": "step", "name": "ref_dp", "state": st, "batch": bt,
          "steps": STEPS, "g": G_KW, "tc": TC_KW, "draws": dr}
    run_ranks(2, 1, [
        {"kind": "collectives"}, dp,
        {"kind": "dt", "params": pp, "clip": cp, "dt": DT_SHARD_KW}], out)
    return out, dict(jstate0=jstate0, real=real, y=y, params=params,
                     clip=clip, dp=dp)


def test_cross_replica_moments_match_the_reference(ranks):
    out, _ = ranks
    rng = np.random.RandomState(0)      # the collectives job's x
    x = rng.randn(6, 5, 5, 4).astype(np.float32)
    mesh = jparallel.make_mesh((2,), ("data",), devices=jax.devices()[:2])
    f = jax.shard_map(lambda xx: jnorm._batch_moments(xx, "data"),
                      mesh=mesh, in_specs=P("data"), out_specs=P(),
                      check_vma=False)
    mean, var = (np.asarray(v) for v in f(jnp.asarray(x)))
    for r in range(2):
        res = np.load(os.path.join(out, f"collectives_r{r}.npz"))
        np.testing.assert_allclose(res["mean"], mean, atol=1e-6)
        np.testing.assert_allclose(res["var"], var, atol=1e-6)


def test_two_rank_step_matches_the_reference_rng_shards_step(ranks):
    out, inp = ranks
    ref, metrics = reference_steps(inp["jstate0"], inp["real"], inp["y"])
    res = rank_results(out, "ref_dp", 2)[0]
    got = state_of(res)
    for s, m in enumerate(metrics):
        for k in LOSSES:
            assert abs(m[k] - float(res[f"m{s}/{k}"])) <= 1e-3, (s, k)
    assert got.keys() == ref.keys()
    for model in ("ds", "dt"):
        for kind in ("params/", "opt/0/mu/", "opt/0/nu/"):
            keys = [k for k in ref if k.startswith(f"{model}/{kind}")]
            scale = max(np.abs(ref[k]).max() for k in keys)
            for k in keys:
                np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                           atol=1e-5 * scale, err_msg=k)
    mu = [k for k in ref if k.startswith("g/opt/0/mu/")]
    scale = max(np.abs(ref[k]).max() for k in mu)
    gap = max(np.abs(got[k] - ref[k]).max() for k in mu) / scale
    assert gap <= 5e-4, gap
    assert int(got["step"]) == int(ref["step"])
    # and the ranks against the port's own one process fed the same draws
    gaps = mu_gaps(one_process(inp["dp"], 2)[0], got)
    assert gaps["ds"] <= 1e-5 and gaps["dt"] <= 1e-5 and gaps["g"] <= 1e-4


def test_time_sharded_dt_matches_the_reference_make_sharded_dt(ranks):
    out, inp = ranks
    cfg = JDTConfig(**DT_SHARD_KW)
    mesh = jparallel.make_mesh((2,), ("time",), devices=jax.devices()[:2])
    clip, y = jnp.asarray(inp["clip"]), jnp.asarray([2, 4])

    def loss(p):
        return jtime_shard.make_sharded_dt(p, cfg, mesh)(clip, y).sum()

    want = np.asarray(jax.jit(
        lambda p: jtime_shard.make_sharded_dt(p, cfg, mesh)(clip, y))(
            inp["params"]))
    grads = flat_np(jax.jit(jax.grad(loss))(inp["params"]))
    res = [dict(np.load(os.path.join(out, f"dt_r{r}.npz"))) for r in range(2)]
    for r in res:
        np.testing.assert_allclose(r["scores"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # each rank's gradient is 2× its own share (the score's all-sum
    # transposes to an all-sum); their mean is the whole clip's gradient
    scale = max(np.abs(g).max() for g in grads.values())
    assert grads.keys() == {k[len("grad/"):] for k in res[0]
                            if k.startswith("grad/")}
    for k, g in grads.items():
        mean = (res[0][f"grad/{k}"] + res[1][f"grad/{k}"]) / 2
        np.testing.assert_allclose(mean, g, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
