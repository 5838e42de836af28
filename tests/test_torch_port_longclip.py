"""The long-clip path (per-level remat, grad accumulation, the 256 px
schedules), port vs dvdgan_tpu.

  * G with `remat=True` gives the loss, every gradient and the BN stats of
    the plain forward, bitwise; the sequence kernels' entry runs once per
    level in a forward + backward, and the upsample conv runs once per
    level (its output is kept, not recomputed);
  * one `train_step` with `grad_accum=2` and `remat=True` from the same
    state and the reference's own draws gives the reference's losses and
    new state (`dvdgan_tpu.train.step.train_step`, jitted), at the
    tolerances of `test_torch_port_train.py`: losses atol 1e-4; state
    leaves atol 1e-5 (Adam nu rtol 1e-3); params atol 1e-6 where
    |grad| ≥ 1e-4 and within 2·lr elsewhere (Adam's first update is about
    lr·sign(g)); Adam mu (the gradient, β1 = 0) within 5e-6 × max|mu| for
    DS and DT (measured 1.5e-6) and 5e-5 × max|mu| for G. G's gradient on
    this batch of 4 differs from the reference's by 2.6e-5 × max|mu|, and
    by 2.9e-5 without accumulation or remat, so neither causes it; the
    port's own f32 gradient is within 3.2e-7 × max|mu| of the port run in
    float64, so the rest is the f32 summation order of the XLA CPU side
    (BN moments over T·B·H·W terms);
  * with `grad_accum=2` the D updates are the `grad_accum=1` ones up to
    float reassociation of the mean (atol 2e-6, rtol 1e-5, the reference's
    own test's), while G differs only by its per-micro-batch BN;
  * G, DS and DT forward at the 256 px schedules (7 channel multipliers,
    z_dim 112 in 7 chunks, 6 GRU levels, 7 DS and 6 DT blocks; ch 2, T 2,
    batch 1)
    against the JAX models, f32 atol 2e-5 × max(1, max|ref|); G in train
    mode atol 5e-4: six BNs with batch statistics over up to 2·256² values
    at 2–32 channels amplify f32 summation order (measured against the
    port run in float64: the port's f32 clip 1.1e-4 away, the reference's
    2.3e-4; in eval mode the two f32 clips agree to 2e-5);
  * the whole train state at that topology crosses `interop` bitwise.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dvdgan_tpu.core import tree as jtree
from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.models import discriminator as jdisc
from dvdgan_tpu.models import generator as jgen
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu_torch import interop, kernels
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.models import (DSConfig, DTConfig, GConfig,
                                     discriminator, generator)
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step

G_KW = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16)
DS_KW = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
DT_KW = dict(img_size=32, n_frames=4, ch=8, n_classes=5)
TC_KW = dict(d_steps=2, ema_start=0)
B = 4
# the 256 px schedules at a width and length the CPU takes in seconds
G256 = dict(img_size=256, n_frames=2, ch=2, z_dim=112, n_classes=5,
            emb_dim=8, attn_res=32)
DS256 = dict(img_size=256, ch=2, n_classes=5, k_frames=2)
DT256 = dict(img_size=256, n_frames=2, ch=2, n_classes=5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it:
    the suite runs six workers on the machine's cores, where torch's default
    of a thread a core oversubscribes them (`test_torch_port_fp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(x):
    """JAX/numpy tree -> torch tree of f32 leaves."""
    if isinstance(x, dict):
        return {k: tt(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tt(v) for v in x]
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def perturbed(params, seed: int, scale: float = 0.05):
    """Weights off the orthogonal init, biases and γ non-zero."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.randn(
        *np.shape(a))).astype(np.float32), params)


def flat_np(jax_tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in
            jtree.flatten_with_paths(jax_tree).items()}


# ------------------------------------------------------------------ remat ---

class ConvCount(TorchDispatchMode):
    """Counts the convolutions that really run, by kernel size."""

    def __init__(self):
        super().__init__()
        self.n: dict[tuple, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            k = tuple(args[1].shape[-2:])
            self.n[k] = self.n.get(k, 0) + 1
        return func(*args, **(kwargs or {}))


def g_loss_and_grads(cfg: GConfig, params, stats, z, y, monkeypatch):
    """(loss, {path: grad}, new stats, GRU entry calls, conv counts) of one
    forward + backward through G."""
    calls = []
    entry = kernels.gru_sequence_fused
    monkeypatch.setattr(kernels, "gru_sequence_fused",
                        lambda *a: calls.append(1) or entry(*a))
    leaves = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree.flatten_with_paths(leaves)
    weights = torch.linspace(-1.0, 1.0, 2 * 4 * 32 * 32 * 3).reshape(
        2, 4, 32, 32, 3)
    with ConvCount() as convs:
        video, new_stats = generator.apply(leaves, stats, z, y, cfg,
                                           train=True)
        loss = (video * weights).sum() + (video ** 2).mean()
        grads = torch.autograd.grad(loss, list(flat.values()))
    return (loss.detach(), dict(zip(flat, grads)),
            tree.flatten_with_paths(new_stats), len(calls), convs.n)


def test_remat_equals_plain_and_reruns_no_sequence(monkeypatch):
    cfg = GConfig(**G_KW)
    gen = torch.Generator().manual_seed(0)
    params, stats = generator.init(gen, cfg)
    params = tree.tree_map(
        lambda p: p + 0.05 * torch.randn(p.shape, generator=gen), params)
    z = torch.randn(2, cfg.z_dim, generator=gen)
    y = torch.tensor([1, 3])
    plain = g_loss_and_grads(cfg, params, stats, z, y, monkeypatch)
    remat = g_loss_and_grads(dataclasses.replace(cfg, remat=True), params,
                             stats, z, y, monkeypatch)
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys() and len(plain[1]) > 40
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k
        assert float(g.abs().max()) > 0, k
    for k, s in plain[2].items():       # BN stats: the first forward's
        assert torch.equal(s, remat[2][k]), k
        assert not torch.equal(s, tree.flatten_with_paths(stats)[k]), k
    # the sequence entry: once per level, backward included
    assert plain[3] == remat[3] == cfg.n_levels
    # the upsample conv (the one 2×2 kernel) ran once per level in both;
    # remat recomputed some of the 3×3 convs of the blocks' tails
    assert plain[4][(2, 2)] == remat[4][(2, 2)] == cfg.n_levels
    assert remat[4][(3, 3)] > plain[4][(3, 3)]


def test_remat_is_off_without_a_backward(monkeypatch):
    """Under no_grad (the D phase's fake pass, sampling) remat does
    nothing: no checkpoint region is entered."""
    cfg = GConfig(**{**G_KW, "remat": True})
    gen = torch.Generator().manual_seed(1)
    params, stats = generator.init(gen, cfg)
    monkeypatch.setattr(generator.ckpt, "checkpoint", None)  # would raise
    with torch.no_grad():
        video, _ = generator.apply(params, stats,
                                   torch.randn(2, cfg.z_dim, generator=gen),
                                   torch.tensor([0, 2]), cfg, train=True)
    assert video.shape == (2, 4, 32, 32, 3)


# ------------------------------------------------ grad accumulation, step ---

def reference_state(seed: int) -> dict:
    """A dvdgan_tpu train state off its init: weights perturbed (an
    orthogonal init makes every SN u a fixed point), attention γ ≠ 0, BN
    stats non-trivial, and one Adam step's worth of moments and count."""
    s = jstate.create(jax.random.PRNGKey(seed), JGConfig(**G_KW),
                      JDSConfig(**DS_KW), JDTConfig(**DT_KW),
                      jstate.TrainConfig(**TC_KW))
    rng = np.random.RandomState(seed)

    def perturb(a, scale=0.05):
        a = np.asarray(a)
        return (a + scale * rng.randn(*a.shape)).astype(a.dtype)

    for m in ("g", "ds", "dt"):
        s[m]["params"] = jax.tree.map(perturb, s[m]["params"])
        opt = s[m]["opt"][0]
        s[m]["opt"] = (opt._replace(
            count=jnp.int32(3),
            mu=jax.tree.map(lambda a: perturb(a, 1e-3), opt.mu),
            nu=jax.tree.map(lambda a: np.abs(perturb(a, 1e-4)), opt.nu)),
            ) + tuple(s[m]["opt"][1:])
    s["g"]["params"]["attn"]["spatial"]["gamma"] = np.float32(0.6)
    s["g"]["params"]["attn"]["temporal"]["gamma"] = np.float32(-0.5)
    s["g"]["stats"] = jax.tree.map(
        lambda a: np.abs(perturb(a, 0.1)), s["g"]["stats"])
    s["g_ema"] = jax.tree.map(perturb, s["g"]["params"])
    s["step"] = jnp.int32(5)
    return jax.tree.map(jnp.asarray, s)


class ReferenceDraws:
    """The reference step's draws for `key`, stream by stream."""

    def __init__(self, key, b, z_dim, t, k):
        self.keys = jax.random.split(key, 3 * TC_KW["d_steps"] + 2)
        self.b, self.z_dim, self.t, self.k = b, z_dim, t, k

    def z(self, i):
        return torch.from_numpy(np.asarray(jax.random.normal(
            self.keys[i], (self.b, self.z_dim), jnp.float32)))

    def idx(self, i):
        return torch.from_numpy(np.asarray(jstep.sample_frame_indices(
            self.keys[i], self.b, self.t, self.k))).long()


def batch(seed: int):
    rng = np.random.RandomState(seed)
    real = np.tanh(rng.randn(B, G_KW["n_frames"], 32, 32, 3)).astype(
        np.float32)
    return real, np.array([1, 4, 0, 2], np.int32)


def port_step(state0, real, y, key, grad_accum: int, remat: bool):
    draws = ReferenceDraws(key, B, G_KW["z_dim"], G_KW["n_frames"],
                           DS_KW["k_frames"])
    return step.train_step(
        state0, torch.from_numpy(real), torch.from_numpy(y).long(), draws,
        GConfig(**G_KW, remat=remat), DSConfig(**DS_KW), DTConfig(**DT_KW),
        train_state.TrainConfig(**TC_KW, grad_accum=grad_accum))


@pytest.fixture(scope="module")
def accum_step():
    """(reference state, reference new state and metrics with grad_accum=2
    and remat, the port's new state and metrics for the same, the port's
    for grad_accum=1 without remat) — all flat numpy except the metrics."""
    jstate0 = reference_state(0)
    real, y = batch(1)
    key = jax.random.PRNGKey(2)
    f = jax.jit(functools.partial(
        jstep.train_step, g_cfg=JGConfig(**G_KW, remat=True),
        ds_cfg=JDSConfig(**DS_KW), dt_cfg=JDTConfig(**DT_KW),
        tc=jstate.TrainConfig(**TC_KW, grad_accum=2)))
    jnew, jmetrics = f(jstate0, jnp.asarray(real), jnp.asarray(y), key)
    state0 = interop.load_train_state(flat_np(jstate0))
    new, metrics = port_step(state0, real, y, key, grad_accum=2, remat=True)
    new1, metrics1 = port_step(state0, real, y, key, grad_accum=1,
                               remat=False)
    return (flat_np(jstate0), flat_np(jnew), jmetrics,
            interop.train_state_to_flat(new), metrics,
            interop.train_state_to_flat(new1), metrics1)


def test_accum_step_losses_match_reference(accum_step):
    _, _, jmetrics, _, metrics, _, _ = accum_step
    assert set(metrics) == {"d_loss", "d_loss_s", "d_loss_t", "g_loss"}
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        np.testing.assert_allclose(float(v), float(jmetrics[k]), atol=1e-4,
                                   err_msg=k)


def test_accum_step_state_matches_reference(accum_step):
    old, ref, _, ours, _, _, _ = accum_step
    assert ours.keys() == ref.keys()
    lr = {"g": train_state.TrainConfig().lr_g,
          "ds": train_state.TrainConfig().lr_d,
          "dt": train_state.TrainConfig().lr_d}
    mu_scale = {m: max(np.abs(v).max() for k, v in ref.items()
                       if k.startswith(f"{m}/opt/0/mu/")) for m in lr}
    n_params = n_small = 0
    for k, want in ref.items():
        got = ours[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        model, kind = (k.split("/") + [""])[:2]
        if kind == "params":
            # mu is the gradient (β1 = 0) at the reference's update
            grad = ref[k.replace("/params/", "/opt/0/mu/", 1)]
            big = np.abs(grad) >= 1e-4
            np.testing.assert_allclose(got[big], want[big], atol=1e-6,
                                       rtol=0, err_msg=k)
            assert np.all(np.abs(got - want)[~big] <= 2 * lr[model]), k
            n_params += got.size
            n_small += int((~big).sum())
        elif k.endswith("/count") or k == "step":
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif kind == "opt" and "/opt/0/mu/" in k:
            atol = (5e-5 if model == "g" else 5e-6) * mu_scale[model]
            np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                       err_msg=k)
        else:
            rtol = 1e-3 if "/opt/0/nu/" in k else 0
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=rtol,
                                       err_msg=k)
    assert n_small < 0.2 * n_params
    for k in ("g/sn_u/levels/0/gru/gates_h/w", "ds/sn_u/blocks/0/conv1/w",
              "dt/sn_u/blocks/0/conv1/w", "g/stats/out_bn/mean"):
        assert not np.allclose(ref[k], old[k]), k
    assert int(ours["step"]) == int(old["step"]) + 1


def test_accum_d_updates_equal_full_batch_ones(accum_step):
    """The D phase with grad_accum=2 is the full-batch one up to the
    mean's reassociation; G's update differs (per-micro-batch BN) but
    stays close, and its SN u (a function of the params) is the same."""
    _, _, _, acc, m_acc, full, m_full = accum_step
    n_d = 0
    for k, want in full.items():
        model, kind = (k.split("/") + [""])[:2]
        if model in ("ds", "dt") and kind in ("params", "sn_u"):
            np.testing.assert_allclose(acc[k], want, atol=2e-6, rtol=1e-5,
                                       err_msg=k)
            n_d += 1
        elif model == "g" and kind == "sn_u":
            np.testing.assert_array_equal(acc[k], want, err_msg=k)
    assert n_d > 50
    for k in ("d_loss", "d_loss_s", "d_loss_t"):
        assert abs(float(m_acc[k]) - float(m_full[k])) < 1e-5, k
    g_diff = max(np.abs(acc[k] - full[k]).max() for k in full
                 if k.startswith("g/params/"))
    assert 0 < g_diff < 1e-2
    assert not np.array_equal(acc["g/stats/out_bn/mean"],
                              full["g/stats/out_bn/mean"])


def test_train_step_refuses_a_batch_grad_accum_does_not_divide():
    state = train_state.create(0, GConfig(**G_KW), DSConfig(**DS_KW),
                               DTConfig(**DT_KW))
    real, y = batch(0)
    with pytest.raises(ValueError, match="not divisible by grad_accum 3"):
        step.train_step(state, torch.from_numpy(real),
                        torch.from_numpy(y).long(), None, GConfig(**G_KW),
                        DSConfig(**DS_KW), DTConfig(**DT_KW),
                        train_state.TrainConfig(**TC_KW, grad_accum=3))


# ------------------------------------------------- the 256 px schedules ----

def close(ours, ref, atol=2e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours.detach().float().numpy(), ref, rtol=1e-5,
                               atol=atol * max(1.0, float(np.abs(ref).max())))


def test_topology_at_256_matches_reference():
    g, jg = GConfig(**G256), JGConfig(**G256)
    assert g.mults == jg.mults and len(g.mults) == 7
    assert (g.n_levels, g.chunk_dim, g.cond_dim) == (
        jg.n_levels, jg.chunk_dim, jg.cond_dim) == (6, 16, 24)
    assert [g.level_channels(i) for i in range(6)] == [
        jg.level_channels(i) for i in range(6)]
    for cfg, jcfg in ((DSConfig(**DS256), JDSConfig(**DS256)),
                      (DTConfig(**DT256), JDTConfig(**DT256))):
        assert cfg.mults == jcfg.mults and cfg.feat_dim == jcfg.feat_dim


@pytest.mark.parametrize("train", [True, False])
def test_generator_at_256_matches_reference(train):
    jp, jstats = jgen.init(jax.random.PRNGKey(20), JGConfig(**G256))
    p = perturbed(jp, 21)
    p["attn"]["spatial"]["gamma"] = np.float32(0.6)
    p["attn"]["temporal"]["gamma"] = np.float32(-0.5)
    stats = jax.tree.map(lambda a: np.abs(np.asarray(a) + np.float32(0.1)),
                         jstats)
    rng = np.random.RandomState(22)
    z = rng.randn(1, 112).astype(np.float32)
    y = np.array([3], np.int32)
    ref, ref_stats = jgen.apply(jax.tree.map(jnp.asarray, p),
                                jax.tree.map(jnp.asarray, stats),
                                jnp.asarray(z), jnp.asarray(y),
                                JGConfig(**G256), train=train)
    ours, our_stats = generator.apply(tt(p), tt(stats), torch.from_numpy(z),
                                      torch.from_numpy(y).long(),
                                      GConfig(**G256), train=train)
    assert ours.shape == (1, 2, 256, 256, 3)
    close(ours, ref, atol=5e-4 if train else 2e-5)
    ref_flat = flat_np(ref_stats)
    for k, v in tree.flatten_with_paths(our_stats).items():
        close(v, ref_flat[k])


def test_discriminators_at_256_match_reference():
    rng = np.random.RandomState(23)
    clip = np.tanh(rng.randn(1, 2, 256, 256, 3)).astype(np.float32)
    y = np.array([2], np.int32)
    ds_p = perturbed(jdisc.ds_init(jax.random.PRNGKey(24),
                                   JDSConfig(**DS256)), 25)
    dt_p = perturbed(jdisc.dt_init(jax.random.PRNGKey(26),
                                   JDTConfig(**DT256)), 27)
    # DT works on the 2×-pooled clip, one block fewer
    assert (len(ds_p["blocks"]), len(dt_p["blocks"])) == (7, 6)
    close(discriminator.ds_apply(tt(ds_p), torch.from_numpy(clip),
                                 torch.from_numpy(y).long(),
                                 DSConfig(**DS256)),
          jdisc.ds_apply(jax.tree.map(jnp.asarray, ds_p), jnp.asarray(clip),
                         jnp.asarray(y), JDSConfig(**DS256)))
    close(discriminator.dt_apply(tt(dt_p), torch.from_numpy(clip),
                                 torch.from_numpy(y).long(),
                                 DTConfig(**DT256)),
          jdisc.dt_apply(jax.tree.map(jnp.asarray, dt_p), jnp.asarray(clip),
                         jnp.asarray(y), JDTConfig(**DT256)))


def test_train_state_at_256_round_trips_bitwise(tmp_path):
    """The 256 px trees (6 G levels, 7 DS and 6 DT blocks) cross `interop`
    both ways bitwise, and the port's own state has the reference's paths
    and shapes there."""
    s = jstate.create(jax.random.PRNGKey(3), JGConfig(**G256),
                      JDSConfig(**DS256), JDTConfig(**DT256),
                      jstate.TrainConfig(**TC_KW))
    flat = flat_np(s)
    assert "g/params/levels/5/gru/gates_h/w" in flat
    assert "ds/params/blocks/6/conv1/w" in flat
    interop.save_train_state_npz(str(tmp_path / "s.npz"),
                                 interop.load_train_state(flat))
    again = interop.train_state_to_flat(
        interop.load_train_state_npz(str(tmp_path / "s.npz")))
    assert again.keys() == flat.keys()
    for k, v in again.items():
        assert v.dtype == flat[k].dtype, k
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    ours = interop.train_state_to_flat(train_state.create(
        0, GConfig(**G256), DSConfig(**DS256), DTConfig(**DT256)))
    assert ours.keys() == flat.keys()
    for k, v in ours.items():
        assert v.shape == flat[k].shape and v.dtype == flat[k].dtype, k
