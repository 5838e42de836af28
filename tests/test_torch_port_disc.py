"""The discriminator side of the port against dvdgan_tpu: DS/DT topology,
conv3d, the pools, DBlock/DBlock3D, DS and DT (with and without the
caller's φ pre-pool), the hinge losses, and spectral norm's gradient.

Same inputs (numpy, from seeds) and the same weights through the JAX
function and its port counterpart; f32, JAX at `highest` matmul precision
(conftest); atol 2e-5 (1e-5 for ∂σ/∂W). The 2×2 mean pools match
bitwise in f32 and bf16 (both accumulate in the activation dtype, in the
same order); the sum pool to f32 rounding. The hinge losses match exactly
on scores whose sums round nowhere (so the order of the sum and the
form of the ÷n cannot matter), and to f32 rounding (1e-6) on random
scores.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import discriminator as jdisc
from dvdgan_tpu.ops import layers as jlayers
from dvdgan_tpu.ops import losses as jlosses
from dvdgan_tpu.ops import resblocks as jres
from dvdgan_tpu.ops import resize as jresize
from dvdgan_tpu.ops import spectral_norm as jsn
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.models import DSConfig, DTConfig, discriminator
from dvdgan_tpu_torch.ops import layers, losses, resblocks, resize
from dvdgan_tpu_torch.ops import spectral_norm as sn

ATOL = 2e-5


def tt(x):
    """JAX/numpy tree -> torch tree of f32 leaves."""
    if isinstance(x, dict):
        return {k: tt(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tt(v) for v in x]
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def perturbed(params, seed: int):
    """Weights off the orthogonal init, biases non-zero."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + np.float32(0.1) * rng.randn(
        *a.shape).astype(np.float32), params)


def close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("img,ch,t", [(32, 8, 4), (64, 32, 16),
                                      (128, 32, 12), (256, 32, 48)])
def test_dconfig_topology_matches_reference(img, ch, t):
    for ours, ref in ((DSConfig(img_size=img, ch=ch, k_frames=3),
                       JDSConfig(img_size=img, ch=ch, k_frames=3)),
                      (DTConfig(img_size=img, ch=ch, n_frames=t),
                       JDTConfig(img_size=img, ch=ch, n_frames=t))):
        assert ours.mults == ref.mults
        assert ours.feat_dim == ref.feat_dim
    assert ours.input_size == ref.input_size
    assert ours.n_3d_blocks == ref.n_3d_blocks


@pytest.mark.parametrize("k,cin,cout,bias", [((3, 3, 3), 3, 8, True),
                                             ((3, 3, 3), 8, 6, False),
                                             ((1, 1, 1), 5, 7, True)])
def test_conv3d_matches_reference(k, cin, cout, bias):
    p = perturbed(jlayers.conv3d_init(jax.random.PRNGKey(0), k, cin, cout,
                                      use_bias=bias), 1)
    x = np.random.RandomState(2).randn(2, 4, 6, 5, cin).astype(np.float32)
    ref = jlayers.conv3d(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    ours = layers.conv3d(tt(p), torch.from_numpy(x))
    assert ours.is_contiguous() and ours.shape == ref.shape
    close(ours, ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pools_match_reference(dtype):
    rng = np.random.RandomState(3)
    x4 = rng.randn(3, 8, 6, 5).astype(np.float32)
    x5 = rng.randn(2, 3, 8, 6, 5).astype(np.float32)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    for jf, tf, x in ((jresize.avg_pool_2x, resize.avg_pool_2x, x4),
                      (jresize.avg_pool_2x_video, resize.avg_pool_2x_video,
                       x5)):
        ref = jf(jnp.asarray(x).astype(jd))
        ours = tf(torch.from_numpy(x).to(td))
        assert ours.dtype == td and tuple(ours.shape) == ref.shape
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    ref = jresize.global_sum_pool(jnp.asarray(x4))
    np.testing.assert_allclose(resize.global_sum_pool(
        torch.from_numpy(x4)).numpy(), np.asarray(ref), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("cin,cout,down,first", [
    (3, 8, True, True),      # from-RGB block: no pre-ReLU, 1×1 skip
    (8, 8, True, False),     # identity skip, pooled
    (8, 12, True, False),    # width change: pool, then 1×1 skip
    (8, 8, False, False),    # final non-downsampling block
])
def test_dblock_matches_reference(cin, cout, down, first):
    p = perturbed(jres.dblock_init(jax.random.PRNGKey(4), cin, cout,
                                   first=first), 5)
    x = np.random.RandomState(6).randn(2, 8, 8, cin).astype(np.float32)
    ref = jres.dblock(jax.tree.map(jnp.asarray, p), jnp.asarray(x), down,
                      first)
    close(resblocks.dblock(tt(p), torch.from_numpy(x), down, first), ref)


@pytest.mark.parametrize("cin,cout,down,first", [
    (3, 8, True, True),
    (8, 8, False, False),
    (8, 12, True, False),
])
def test_dblock3d_matches_reference(cin, cout, down, first):
    p = perturbed(jres.dblock3d_init(jax.random.PRNGKey(7), cin, cout,
                                     first=first), 8)
    x = np.random.RandomState(9).randn(2, 4, 8, 8, cin).astype(np.float32)
    ref = jres.dblock3d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), down,
                        first)
    close(resblocks.dblock3d(tt(p), torch.from_numpy(x), down, first), ref)


def test_ds_matches_reference():
    cfg_kw = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
    p = perturbed(jdisc.ds_init(jax.random.PRNGKey(10), JDSConfig(**cfg_kw)),
                  11)
    frames = np.tanh(np.random.RandomState(12).randn(3, 2, 32, 32, 3)
                     ).astype(np.float32)
    y = np.array([0, 4, 2], np.int32)
    ref = jdisc.ds_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(frames),
                         jnp.asarray(y), JDSConfig(**cfg_kw))
    ours = discriminator.ds_apply(tt(p), torch.from_numpy(frames),
                                  torch.from_numpy(y).long(),
                                  DSConfig(**cfg_kw))
    assert ours.shape == (3,)
    close(ours, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("pooled", [False, True])
def test_dt_matches_reference(pooled):
    cfg_kw = dict(img_size=32, n_frames=4, ch=8, n_classes=5)
    p = perturbed(jdisc.dt_init(jax.random.PRNGKey(13), JDTConfig(**cfg_kw)),
                  14)
    clip = np.tanh(np.random.RandomState(15).randn(3, 4, 32, 32, 3)
                   ).astype(np.float32)
    y = np.array([1, 3, 0], np.int32)
    ref = jdisc.dt_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(clip),
                         jnp.asarray(y), JDTConfig(**cfg_kw))
    x = torch.from_numpy(clip)
    if pooled:      # the caller's φ pre-pool gives the same scores
        x = resize.avg_pool_2x_video(x)
    ours = discriminator.dt_apply(tt(p), x, torch.from_numpy(y).long(),
                                  DTConfig(**cfg_kw), pooled=pooled)
    assert ours.shape == (3,)
    close(ours, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def test_port_d_init_paths_match_reference():
    for port_init, ref_init, cfg, jcfg in (
            (discriminator.ds_init, jdisc.ds_init,
             DSConfig(img_size=32, ch=8), JDSConfig(img_size=32, ch=8)),
            (discriminator.dt_init, jdisc.dt_init,
             DTConfig(img_size=32, ch=8), JDTConfig(img_size=32, ch=8))):
        ours = tree.flatten_with_paths(port_init(torch.Generator(), cfg))
        ref = {k: v for k, v in tree.flatten_with_paths(
            ref_init(jax.random.PRNGKey(0), jcfg)).items()}
        assert ours.keys() == ref.keys()
        for k, v in ours.items():
            assert tuple(v.shape) == ref[k].shape, k


def test_hinge_losses_match_reference_exactly():
    rng = np.random.RandomState(16)
    # 8 scores on a 1/16 grid: every partial sum, and the mean (÷8 or ×1/8),
    # is exact in f32
    dyadic = [(rng.randint(-64, 64, 8) / 16).astype(np.float32)
              for _ in range(2)]
    rand = [(3 * rng.randn(7)).astype(np.float32) for _ in range(2)]
    for (real, fake), exact in ((dyadic, True), (rand, False)):
        for ours, ref in (
                (losses.d_hinge(torch.from_numpy(real),
                                torch.from_numpy(fake)),
                 jlosses.d_hinge(jnp.asarray(real), jnp.asarray(fake))),
                (losses.g_hinge(torch.from_numpy(fake)),
                 jlosses.g_hinge(jnp.asarray(fake)))):
            assert ours.dtype == torch.float32
            if exact:
                assert float(ours) == float(ref)
            else:
                np.testing.assert_allclose(float(ours), float(ref),
                                           rtol=1e-6, atol=1e-6)
    got = losses.d_hinge(torch.from_numpy(real).bfloat16(),
                         torch.from_numpy(fake).bfloat16())
    assert got.dtype == torch.float32


@pytest.mark.parametrize("shape", [(3, 3, 4, 6), (3, 3, 3, 4, 5), (7, 5)])
def test_sn_gradient_matches_jax(shape):
    """∂/∂W of a weighted sum of W/σ(W) (σ = vᵀWu with u, v held constant,
    so ∂σ/∂W = v uᵀ), port autograd against jax.grad."""
    rng = np.random.RandomState(17)
    w = rng.randn(*shape).astype(np.float32)
    u = rng.randn(shape[-1]).astype(np.float32)
    u /= np.linalg.norm(u)
    c = rng.randn(*shape).astype(np.float32)

    def jloss(w):
        p, new_u = jsn.sn_normalize({"w": w}, {"w": jnp.asarray(u)},
                                    update=True)
        return jnp.sum(p["w"] * c), new_u

    (jl, ju), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    p, new_u = sn.sn_normalize({"w": tw}, {"w": torch.from_numpy(u)},
                               update=True)
    loss = (p["w"] * torch.from_numpy(c)).sum()
    (tg,) = torch.autograd.grad(loss, [tw])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(new_u["w"].numpy(), np.asarray(ju["w"]),
                               atol=1e-6)
    assert not new_u["w"].requires_grad
    sigma, _ = sn.sigma_and_update(tw, torch.from_numpy(u))
    (dsigma,) = torch.autograd.grad(sigma, [tw])
    jdsigma = jax.grad(lambda w: jsn.sigma_and_update(
        w, jnp.asarray(u))[0])(jnp.asarray(w))
    np.testing.assert_allclose(dsigma.numpy(), np.asarray(jdsigma),
                               atol=1e-5)
