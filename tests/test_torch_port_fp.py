"""DVD-GAN-FP (video prediction, `cond_frames > 0`), port vs dvdgan_tpu, at
the configs of `tests/test_fp.py` (img 32, ch 8, cond_frames 2, generated
T 4; f32, JAX at `highest` matmul precision, conftest):

  * the strided `ops.layers.conv2d` against `lax.conv_general_dilated`
    (XLA's SAME padding: a stride-2 3×3 conv over an even size pads (0, 1))
    at stride 1 and 2, even and odd sizes, atol 1e-5;
  * the frame encoder's taps, and FP `generator.apply` in eval and train
    mode, with the reference's weights carried by `interop`, atol 1e-4 (as
    `test_torch_port_sample.py`);
  * G's gradient through the warm-up, the encoder included, against
    `jax.grad` (atol 1e-5 × max|grad| of the whole tree: f32 sums over
    thousands of terms in another order);
  * remat on and off give the same bits, with the GRU's forward entry run
    twice a level (warm-up and generation) and its backward twice a level,
    never from a remat replay;
  * one FP `train_step` (pooled fakes, d_steps 1) against the reference's,
    through the draw hook, at the tolerances of `test_torch_port_train.py`
    (`assert_state_close`), with one judge changed: XLA:CPU's f32 G
    gradient lies up to 2e-4 × max|mu| off its float64 value at this scale
    (2e-4 in the synthesis step at d_steps 1, 1.9e-4 in this one; 1e-6 at
    other seeds), while the port's f32 lies within 2e-7 of the port run in
    float64. So G's new params, Adam moments and EMA are held at those
    tolerances to the port's float64 step from the same state and draws
    (`port_step_f64`), and G's mu (the gradient) to the reference's at
    5e-4 × max|mu|;
  * `sample(cond_video=…)` through an npz; the FP train state's paths and
    its round trip through `interop` and through
    `tools/orbax_to_port_checkpoint.py` (from an Orbax checkpoint),
    bitwise; `MultiStep` at K 2 (eager on the CPU) against two single
    steps, bitwise; the config's FP fields; `Trainer.cond_fixed` against
    the reference trainer's dataset prefix; the sample CLI in process.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu import data as jdata
from dvdgan_tpu.core import tree as jtree
from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.models import generator as jgen
from dvdgan_tpu.ops import layers as jlayers
from dvdgan_tpu.train import checkpoint as jckpt
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu.train import trainer as jtrainer
from dvdgan_tpu.utils import config as jconfig
from dvdgan_tpu_torch import cli, interop, kernels
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.kernels import convgru_bwd
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig, generator
from dvdgan_tpu_torch.ops import layers
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import checkpoint as ckpt
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging
from dvdgan_tpu_torch.utils.config import Config, parse_config
from test_torch_port_sample import _sn_u, _unflat
from test_torch_port_sample import reference_state as g_reference_state
from tools import orbax_to_port_checkpoint

CF = 2
G_KW = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16, cond_frames=CF)
DS_KW = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
DT_KW = dict(img_size=32, n_frames=CF + 4, ch=8, n_classes=5)  # whole clip
TC_KW = dict(d_steps=1, ema_start=0)
B = 2
LOSSES = ("d_loss", "d_loss_s", "d_loss_t", "g_loss")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it:
    the suite runs six workers on the machine's cores, where torch's default
    of a thread a core oversubscribes them (one FP train step at this scale
    takes 0.13 s on 8 threads and 0.25 s on one of an idle 8-core x86 host,
    and took a hundred times longer there beside five busy workers)."""
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


def flat_np(jax_tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in
            jtree.flatten_with_paths(jax_tree).items()}


def cond_clip(seed: int, b: int = B, t: int = CF) -> np.ndarray:
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, t, 32, 32, 3)).astype(np.float32)


def reference_state(seed: int, g_kw=G_KW, ds_kw=DS_KW, dt_kw=DT_KW,
                    tc_kw=TC_KW) -> dict:
    """A dvdgan_tpu train state off its init, perturbed as
    `test_torch_port_train.reference_state` does: weights off the
    orthogonal init (which makes every SN u a fixed point), attention γ ≠ 0,
    BN stats non-trivial, Adam moments and count, step 5."""
    s = jstate.create(jax.random.PRNGKey(seed), JGConfig(**g_kw),
                      JDSConfig(**ds_kw), JDTConfig(**dt_kw),
                      jstate.TrainConfig(**tc_kw))
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
    """The reference step's draws for `key`, stream by stream (frame
    indices over the t generated frames)."""

    def __init__(self, key, b, z_dim, t, k, d_steps):
        self.keys = jax.random.split(key, 3 * d_steps + 2)
        self.b, self.z_dim, self.t, self.k = b, z_dim, t, k

    def z(self, i):
        return torch.from_numpy(np.array(jax.random.normal(
            self.keys[i], (self.b, self.z_dim), jnp.float32)))

    def idx(self, i):
        return torch.from_numpy(np.array(jstep.sample_frame_indices(
            self.keys[i], self.b, self.t, self.k))).long()


def reference_and_port_step(seed: int, real: np.ndarray, y: np.ndarray,
                            key_seed: int, g_kw=G_KW, ds_kw=DS_KW,
                            dt_kw=DT_KW, tc_kw=TC_KW):
    """One train step of the reference (jitted) and of the port from the
    same state and the reference's draws. -> (old, reference new, its
    metrics, the port's new state, its metrics)."""
    jstate0 = reference_state(seed, g_kw, ds_kw, dt_kw, tc_kw)
    key = jax.random.PRNGKey(key_seed)
    cfgs = (GConfig(**g_kw), DSConfig(**ds_kw), DTConfig(**dt_kw),
            train_state.TrainConfig(**tc_kw))
    f = jax.jit(functools.partial(
        jstep.train_step, g_cfg=JGConfig(**g_kw), ds_cfg=JDSConfig(**ds_kw),
        dt_cfg=JDTConfig(**dt_kw), tc=jstate.TrainConfig(**tc_kw)))
    jnew, jmetrics = f(jstate0, jnp.asarray(real), jnp.asarray(y), key)
    draws = ReferenceDraws(key, real.shape[0], g_kw["z_dim"],
                           g_kw["n_frames"], ds_kw["k_frames"],
                           tc_kw["d_steps"])
    state0 = interop.load_train_state(flat_np(jstate0))
    new, metrics = step.train_step(
        state0, torch.from_numpy(real), torch.from_numpy(y).long(), draws,
        *cfgs)
    return flat_np(jstate0), flat_np(jnew), jmetrics, new, metrics


class Float64Draws:
    """`draws` with z in float64 (the compute dtype follows z)."""

    def __init__(self, draws):
        self.draws = draws

    def z(self, i):
        return self.draws.z(i).double()

    def idx(self, i):
        return self.draws.idx(i)


def port_step_f64(old: dict, real: np.ndarray, y: np.ndarray, key_seed: int,
                  g_kw=G_KW, ds_kw=DS_KW, dt_kw=DT_KW, tc_kw=TC_KW
                  ) -> dict[str, np.ndarray]:
    """The port's new state, flat, from its step run in float64 (σ math
    stays f32) from the flat state `old` and the reference's draws, each
    leaf back in the reference's dtype."""
    state = tree.tree_map(lambda v: v.double() if v.is_floating_point()
                          else v, interop.load_train_state(old))
    draws = ReferenceDraws(jax.random.PRNGKey(key_seed), real.shape[0],
                           g_kw["z_dim"], g_kw["n_frames"],
                           ds_kw["k_frames"], tc_kw["d_steps"])
    new, _ = step.train_step(
        state, torch.from_numpy(real).double(), torch.from_numpy(y).long(),
        Float64Draws(draws), GConfig(**g_kw), DSConfig(**ds_kw),
        DTConfig(**dt_kw), train_state.TrainConfig(**tc_kw))
    return {k: v.astype(old[k].dtype) for k, v in
            interop.train_state_to_flat(new).items()}


def assert_g_close(old: dict, ref: dict, new: dict, f64: dict) -> None:
    """`assert_state_close` with G's params, Adam state and EMA judged by
    the port's float64 step `f64`, and G's mu within 5e-4 × max|mu| of the
    reference's f32 step (module docstring)."""
    judge = {k: f64[k] if k.startswith(("g/params/", "g/opt/", "g_ema/"))
             else v for k, v in ref.items()}
    assert_state_close(old, judge, new)
    ours = interop.train_state_to_flat(new)
    mu = [k for k in ref if k.startswith("g/opt/0/mu/")]
    scale = max(np.abs(ref[k]).max() for k in mu)
    for k in mu:
        np.testing.assert_allclose(ours[k], ref[k], atol=5e-4 * scale,
                                   rtol=0, err_msg=k)


def assert_state_close(old: dict, ref: dict, new: dict) -> None:
    """The port's new state `new` against the reference's `ref` at the
    tolerances of `test_torch_port_train.py`: params atol 1e-6 where
    |grad| ≥ 1e-4 and within 2·lr elsewhere (Adam's first update is about
    lr·sign(g)); Adam mu within 5e-6 × max|mu| of its model; counts and
    step exact; every other leaf atol 1e-5 (nu rtol 1e-3). And the state
    moved: G's SN u, DS's and DT's, and G's BN stats."""
    ours = interop.train_state_to_flat(new)
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
            np.testing.assert_allclose(got, want, atol=5e-6 * mu_scale[model],
                                       rtol=0, err_msg=k)
        else:
            rtol = 1e-3 if "/opt/0/nu/" in k else 0
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=rtol,
                                       err_msg=k)
    assert n_small < 0.2 * n_params
    for k in ("g/sn_u/levels/0/gru/gates_h/w", "ds/sn_u/blocks/0/conv1/w",
              "dt/sn_u/blocks/0/conv1/w", "g/stats/out_bn/mean"):
        assert not np.allclose(ref[k], old[k]), k
    assert int(ours["step"]) == int(old["step"]) + 1


# ------------------------------------------------------------ strided conv --

@pytest.mark.parametrize("stride,size", [(1, 16), (1, 15), (2, 16),
                                         (2, 15)])
def test_strided_conv2d_pads_as_xla(stride, size):
    rng = np.random.RandomState(stride * 100 + size)
    x = rng.randn(2, size, size + 2, 5).astype(np.float32)
    p = {"w": rng.randn(3, 3, 5, 7).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(p["w"]), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["b"]
    got = layers.conv2d(tt(p), torch.from_numpy(x), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the reference's own conv2d (its stem path included at stride 1)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.conv2d(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride)),
        atol=1e-5)


# ---------------------------------------------------------------- generator --

@pytest.fixture(scope="module")
def g_state():
    """The reference's FP G state (perturbed; γ ≠ 0; BN stats set), flat,
    and the port's GeneratorState loaded from it."""
    flat = g_reference_state(G_KW, seed=0)
    return flat, interop.load_generator_state(flat)


def g_trees(state) -> tuple[dict, dict]:
    """(params, stats) of a GeneratorState, detached from its module."""
    params, stats, _ = state.trees()
    return (tree.tree_map(torch.Tensor.detach, params),
            tree.tree_map(torch.Tensor.detach, stats))


def test_fp_encoder_taps_match_reference(g_state):
    flat, state = g_state
    params, _ = g_trees(state)
    assert len(params["fp_enc"]["stages"]) == JGConfig(**G_KW).n_levels + 1
    cond = cond_clip(3)
    ref = jgen._fp_encode(_unflat(flat, "g_ema/"), jnp.asarray(cond),
                          JGConfig(**G_KW))
    ours = generator._fp_encode(params, torch.from_numpy(cond),
                                GConfig(**G_KW))
    assert len(ours) == len(ref) == GConfig(**G_KW).n_levels
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape, i       # (C, B, 4·2^i, 4·2^i, ch·m[i])
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=f"tap {i}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fp_generator_matches_reference(g_state, train):
    flat, state = g_state
    params, stats = g_trees(state)
    rng = np.random.RandomState(1)
    z = rng.randn(B, G_KW["z_dim"]).astype(np.float32)
    y = np.array([0, 4], np.int32)
    cond = cond_clip(2)
    jcfg = JGConfig(**G_KW)
    ref, ref_stats = jax.jit(functools.partial(
        jgen.apply, cfg=jcfg, train=train))(
        _unflat(flat, "g_ema/"), _unflat(flat, "g/stats/"), jnp.asarray(z),
        jnp.asarray(y), cond_video=jnp.asarray(cond))
    ours, our_stats = generator.apply(
        params, stats, torch.from_numpy(z), torch.from_numpy(y).long(),
        GConfig(**G_KW), train, cond_video=torch.from_numpy(cond))
    assert ours.shape == ref.shape == (B, 4, 32, 32, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    ref_flat = jtree.flatten_with_paths(ref_stats)
    for k, v in tree.flatten_with_paths(our_stats).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_flat[k]),
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="requires cond_video"):
        generator.apply(params, stats, torch.from_numpy(z),
                        torch.from_numpy(y).long(), GConfig(**G_KW), train)


def video_weights(t: int = 4) -> np.ndarray:
    return np.linspace(-1.0, 1.0, B * t * 32 * 32 * 3, dtype=np.float32
                       ).reshape(B, t, 32, 32, 3)


def test_fp_generator_gradient_matches_jax_grad(g_state):
    """Train mode; the loss weights every output element differently, so
    every path into the clip — the warm-up's h0 and the encoder among
    them — carries a gradient."""
    flat, state = g_state
    params, stats = g_trees(state)
    rng = np.random.RandomState(4)
    z = rng.randn(B, G_KW["z_dim"]).astype(np.float32)
    y = np.array([3, 1], np.int32)
    cond, w = cond_clip(5), video_weights()
    jcfg = JGConfig(**G_KW)

    def jloss(p):
        v, _ = jgen.apply(p, _unflat(flat, "g/stats/"), jnp.asarray(z),
                          jnp.asarray(y), jcfg, True,
                          cond_video=jnp.asarray(cond))
        return jnp.sum(v * w) + jnp.mean(v ** 2)

    ref = jtree.flatten_with_paths(jax.jit(jax.grad(jloss))(
        _unflat(flat, "g_ema/")))
    leaves = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    v, _ = generator.apply(leaves, stats, torch.from_numpy(z),
                           torch.from_numpy(y).long(), GConfig(**G_KW), True,
                           cond_video=torch.from_numpy(cond))
    loss = (v * torch.from_numpy(w)).sum() + (v ** 2).mean()
    flat_leaves = tree.flatten_with_paths(leaves)
    grads = dict(zip(flat_leaves, torch.autograd.grad(
        loss, list(flat_leaves.values()))))
    assert grads.keys() == ref.keys()
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[k]),
                                   atol=1e-5 * scale, rtol=0, err_msg=k)
    enc = [k for k in grads if k.startswith("fp_enc/")]
    assert len(enc) == 2 * (GConfig(**G_KW).n_levels + 1)
    assert all(float(grads[k].abs().max()) > 0 for k in enc)


def g_grads_counted(cfg: GConfig, params, stats, z, y, cond, monkeypatch):
    """(loss, {path: grad}, new stats, forward entry calls, backward calls)
    of one forward + backward through G."""
    fwd, bwd = [], []
    entry, back = kernels.gru_sequence_fused, convgru_bwd.gru_sequence_bwd
    monkeypatch.setattr(kernels, "gru_sequence_fused",
                        lambda *a: fwd.append(1) or entry(*a))
    monkeypatch.setattr(convgru_bwd, "gru_sequence_bwd",
                        lambda *a: bwd.append(1) or back(*a))
    leaves = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree.flatten_with_paths(leaves)
    video, new_stats = generator.apply(leaves, stats, z, y, cfg, train=True,
                                       cond_video=cond)
    loss = (video * torch.from_numpy(video_weights())).sum()
    grads = torch.autograd.grad(loss, list(flat.values()))
    return (loss.detach(), dict(zip(flat, grads)),
            tree.flatten_with_paths(new_stats), len(fwd), len(bwd))


def test_fp_remat_equals_plain_and_reruns_no_sequence(g_state, monkeypatch):
    _, state = g_state
    params, stats = g_trees(state)
    cfg = GConfig(**G_KW)
    gen = torch.Generator().manual_seed(6)
    z = torch.randn(B, cfg.z_dim, generator=gen)
    y = torch.tensor([2, 0])
    cond = torch.from_numpy(cond_clip(7))
    plain = g_grads_counted(cfg, params, stats, z, y, cond, monkeypatch)
    remat = g_grads_counted(dataclasses.replace(cfg, remat=True), params,
                            stats, z, y, cond, monkeypatch)
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys()
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k
    for k, s in plain[2].items():
        assert torch.equal(s, remat[2][k]), k
    # warm-up and generation: one forward entry and one backward a level
    n = 2 * cfg.n_levels
    assert plain[3:] == remat[3:] == (n, n)


# ----------------------------------------------------------- train, sample --

def fp_batch(seed: int):
    rng = np.random.RandomState(seed)
    real = np.tanh(rng.randn(B, CF + 4, 32, 32, 3)).astype(np.float32)
    return real, np.array([1, 4], np.int32)


def test_fp_train_step_matches_reference():
    real, y = fp_batch(1)
    old, ref, jmetrics, new, metrics = reference_and_port_step(
        1, real, y, key_seed=3)
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=1e-4, err_msg=k)
        assert float(metrics[k]) > 0, k    # DS and DT both get a gradient
    assert_g_close(old, ref, new, port_step_f64(old, real, y, key_seed=3))
    # the frame encoder learned through the warm-up
    enc = [k for k in ref if k.startswith("g/params/fp_enc/")]
    assert enc and all(not np.array_equal(ref[k], old[k]) for k in enc)


def test_fp_train_step_checks_the_clip_length():
    state = train_state.create(0, GConfig(**G_KW), DSConfig(**DS_KW),
                               DTConfig(**DT_KW))
    real, y = fp_batch(0)
    with pytest.raises(ValueError, match="cond_frames 2 \\+ n_frames 4"):
        step.train_step(state, torch.from_numpy(real[:, 1:]),
                        torch.from_numpy(y).long(), None, GConfig(**G_KW),
                        DSConfig(**DS_KW), DTConfig(**DT_KW),
                        train_state.TrainConfig(**TC_KW))


def test_fp_sample_matches_reference_through_npz(g_state, tmp_path):
    flat, _ = g_state
    np.savez(tmp_path / "g.npz", **flat)
    state = interop.load_state_npz(str(tmp_path / "g.npz"))
    rng = np.random.RandomState(8)
    z = rng.randn(3, G_KW["z_dim"]).astype(np.float32)
    y = np.array([0, 4, 2], np.int32)
    cond = cond_clip(9, b=3)
    ref = jax.jit(jstep.sample, static_argnames=("g_cfg",))(
        _unflat(flat, "g_ema/"), _unflat(flat, "g/stats/"), _sn_u(flat),
        jnp.asarray(z), jnp.asarray(y), g_cfg=JGConfig(**G_KW),
        cond_video=jnp.asarray(cond))
    ours = step.sample(*state.trees(), torch.from_numpy(z),
                       torch.from_numpy(y).long(), GConfig(**G_KW),
                       cond_video=torch.from_numpy(cond))
    assert ours.shape == ref.shape == (3, 4, 32, 32, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_fp_train_state_paths_and_round_trip(tmp_path):
    ref = flat_np(reference_state(3))
    assert any(k.startswith("g/sn_u/fp_enc/stages/") for k in ref)
    ours = interop.train_state_to_flat(train_state.create(
        0, GConfig(**G_KW), DSConfig(**DS_KW), DTConfig(**DT_KW)))
    assert ours.keys() == ref.keys()
    for k, v in ours.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
    interop.save_train_state_npz(str(tmp_path / "s.npz"),
                                 interop.load_train_state(ref))
    again = interop.train_state_to_flat(
        interop.load_train_state_npz(str(tmp_path / "s.npz")))
    assert again.keys() == ref.keys()
    for k, v in again.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_fp_orbax_checkpoint_converts_bitwise(tmp_path):
    """A reference FP train state saved by the reference's checkpointer,
    converted by the tool: every leaf, the encoder's SN u vectors among
    them, with its bits in the port's checkpoint."""
    ref = reference_state(4)
    jckpt.save(str(tmp_path / "ref"), 5, ref)
    out = orbax_to_port_checkpoint.convert(str(tmp_path / "ref"), 5, ref,
                                           str(tmp_path / "port"))
    got = interop.train_state_to_flat(ckpt.restore(
        os.path.dirname(out), 5, train_state.create(
            0, GConfig(**G_KW), DSConfig(**DS_KW), DTConfig(**DT_KW))))
    want = flat_np(ref)
    assert got.keys() == want.keys()
    assert any(k.startswith("g/sn_u/fp_enc/") for k in got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_fp_multi_step_gives_two_train_steps():
    g_cfg, ds_cfg = GConfig(**G_KW), DSConfig(**DS_KW)
    dt_cfg, tc = DTConfig(**DT_KW), train_state.TrainConfig(**TC_KW)
    state = train_state.create(1, g_cfg, ds_cfg, dt_cfg)
    rng = np.random.RandomState(0)
    reals = torch.from_numpy(np.tanh(rng.randn(2, B, CF + 4, 32, 32, 3))
                             .astype(np.float32))
    ys = torch.from_numpy(rng.randint(0, 5, (2, B)))
    want, want_m = state, []
    for j in range(2):
        draws = step.TorchDraws(9, 6 + j, B, g_cfg.z_dim, g_cfg.n_frames,
                                ds_cfg.k_frames, torch.float32, "cpu")
        want, m = step.train_step(want, reals[j], ys[j], draws, g_cfg,
                                  ds_cfg, dt_cfg, tc)
        want_m.append(m)
    multi = step.MultiStep(state, 2, B, g_cfg, ds_cfg, dt_cfg, tc, 9,
                           torch.float32, "cpu", trainer_mod.launch_counts)
    assert multi.reals.shape == (2, B, CF + 4, 32, 32, 3)
    got, metrics = multi(state, reals, ys, 6)
    flat_got, flat_want = (interop.train_state_to_flat(s)
                           for s in (got, want))
    assert all(np.array_equal(v, flat_got[p]) for p, v in flat_want.items())
    for name, v in metrics.items():
        assert torch.equal(v, torch.stack([m[name] for m in want_m]))


def test_fp_config_flows_to_the_models():
    """`--n_frames` is the whole clip: G generates n_frames − cond_frames,
    DS's k_frames is capped at that, DT scores the whole clip — the
    reference's configs, field for field."""
    for argv in (["--preset", "kinetics_64", "--n_frames", "16",
                  "--cond_frames", "5"],
                 ["--n_frames", "6", "--cond_frames", "2", "--k_frames",
                  "8"]):
        cfg = parse_config(argv)
        ref = jconfig.parse_config(argv)
        for ours, theirs in ((cfg.g_config(), ref.g_config()),
                             (cfg.ds_config(), ref.ds_config()),
                             (cfg.dt_config(), ref.dt_config())):
            for f in dataclasses.fields(theirs):
                assert getattr(ours, f.name) == getattr(theirs, f.name), (
                    argv, f.name)
    g, ds = cfg.g_config(), cfg.ds_config()
    assert (g.n_frames, g.cond_frames, ds.k_frames) == (4, 2, 4)


def test_trainer_cond_fixed_is_the_reference_trainers_prefix(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(trainer_mod, "MetricWriter", functools.partial(
        plogging.MetricWriter, use_tensorboard=False))
    kw = dict(dataset="synthetic", n_classes=5, img_size=32, n_frames=6,
              cond_frames=CF, ch=8, d_ch=8, emb_dim=16, attn_res=16,
              k_frames=2, batch_size=3, d_steps=1, bf16=False, seed=4,
              total_step=0)
    tr = trainer_mod.Trainer(Config(**kw, device="cpu",
                                    out_dir=str(tmp_path / "run")))
    try:
        # the reference trainer's dataset (its `_build_dataset`) and rows
        ref = jtrainer.Trainer.__new__(jtrainer.Trainer)
        ref.cfg = jconfig.Config(**kw)
        ds = ref._build_dataset()
        assert isinstance(ds, jdata.SyntheticVideoDataset)
        want = np.stack([ds[i][0][:CF] for i in range(3)])
        assert tr.cond_fixed.shape == (3, CF, 32, 32, 3)
        np.testing.assert_array_equal(tr.cond_fixed.numpy(), want)
        clips = tr.sample()
        assert clips.shape == (3, 4, 32, 32, 3)
        assert torch.equal(clips, tr.sample(cond=tr.cond_fixed))
        assert not torch.equal(clips, tr.sample(cond=tr.cond_fixed.flip(0)))
    finally:
        tr.close()


def test_fp_sample_cli_conditions_on_dataset_prefixes(tmp_path):
    flags = ["--mode", "sample", "--device", "cpu", "--img_size", "32",
             "--n_frames", "6", "--cond_frames", str(CF), "--ch", "8",
             "--n_classes", "5", "--emb_dim", "16", "--attn_res", "16",
             "--n_samples", "3", "--bf16", "0", "--batch_size", "2",
             "--dataset", "synthetic"]
    clips = cli.main(flags + ["--out_dir", str(tmp_path)])
    assert clips.shape == (3, 4, 32, 32, 3)
    assert np.isfinite(clips).all() and np.abs(clips).max() <= 1.0
    assert np.array_equal(np.load(tmp_path / "samples.npy"), clips)
    # clip i: item i mod len of the reference's dataset, as its main.py
    cfg = parse_config(flags)
    ds = jdata.SyntheticVideoDataset(n_items=64, n_frames=6, img_size=32,
                                     n_classes=5, seed=0)
    cond = np.stack([ds[i % len(ds)][0][:CF] for i in range(3)])
    gen = torch.Generator().manual_seed(cfg.seed + 777)
    z = torch.randn(3, cfg.z_dim, generator=gen)
    y = torch.randint(0, 5, (3,), generator=gen)
    want = step.sample(*generator.GeneratorState.create(
        cfg.g_config(), cfg.seed).trees(), z, y, cfg.g_config(),
        cond_video=torch.from_numpy(cond))
    np.testing.assert_array_equal(clips, want.numpy())
