"""dvdgan_tpu_torch primitives against dvdgan_tpu: config topology and
presets, tree paths, layers, resize, norm and spectral norm.

Same inputs (numpy, from seeds) through the JAX function and its port
counterpart, f32, JAX at `highest` matmul precision (conftest); atol 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.core import tree as jtree
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.ops import layers as jlayers
from dvdgan_tpu.ops import norm as jnorm
from dvdgan_tpu.ops import resize as jresize
from dvdgan_tpu.ops import spectral_norm as jsn
from dvdgan_tpu.utils import config as jconfig
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.models import GConfig
from dvdgan_tpu_torch.ops import layers, norm, resize
from dvdgan_tpu_torch.ops import spectral_norm as sn
from dvdgan_tpu_torch.utils import config

ATOL = 1e-5


def tt(x):
    """JAX/numpy tree -> torch tree (float leaves f32, int leaves kept)."""
    if isinstance(x, dict):
        return {k: tt(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tt(v) for v in x]
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def close(ours, ref, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------- config -------

@pytest.mark.parametrize("img,ch,t", [(32, 8, 4), (64, 32, 16), (128, 32, 12),
                                      (256, 32, 48)])
def test_gconfig_topology_matches_reference(img, ch, t):
    z = 112 if img == 256 else 120
    ours = GConfig(img_size=img, ch=ch, n_frames=t, z_dim=z)
    ref = JGConfig(img_size=img, ch=ch, n_frames=t, z_dim=z)
    assert ours.mults == ref.mults
    assert ours.n_levels == ref.n_levels
    assert ours.chunk_dim == ref.chunk_dim
    assert ours.cond_dim == ref.cond_dim
    assert ([ours.level_channels(i) for i in range(ours.n_levels)]
            == [ref.level_channels(i) for i in range(ref.n_levels)])


def test_presets_and_flags_match_reference():
    assert config.PRESETS == jconfig.PRESETS
    for name in config.PRESETS:
        argv = ["--preset", name, "--seed", "3", "--bf16", "0"]
        ours = config.parse_config(argv + ["--mode", "sample"])
        ref = jconfig.parse_config(argv + ["--mode", "sample"])
        # `ups_fused`, `attn_fused` and `remat_save` are the port's fields
        # for what the reference reads from the environment
        # (DVDGAN_UPS_PALLAS, DVDGAN_ATTN_PALLAS, DVDGAN_REMAT_SAVE), with
        # its defaults
        g = dataclass_dict(ours.g_config())
        assert g.pop("ups_fused") == "off"
        assert g.pop("attn_fused") == "off"
        assert g.pop("remat_save") == "gru+ups"
        assert g == dataclass_dict(ref.g_config())
        assert (ours.seed, ours.bf16, ours.n_samples) == (
            ref.seed, ref.bf16, ref.n_samples)
        # the train mode's D and loop configs: every field the port has
        assert (dataclass_dict(ours.ds_config())
                == dataclass_dict(ref.ds_config()))
        assert (dataclass_dict(ours.dt_config())
                == dataclass_dict(ref.dt_config()))
        tc, ref_tc = (dataclass_dict(c.train_config()) for c in (ours, ref))
        assert tc == {k: ref_tc[k] for k in tc}


def dataclass_dict(c):
    import dataclasses
    return dataclasses.asdict(c)


def test_tree_paths_round_trip_through_module():
    t = {"levels": [{"gru": {"w": torch.ones(2)}}, {"gru": {"w": torch.zeros(3)}}],
         "seed": {"w": torch.ones(1, 2), "b": torch.zeros(2)}}
    flat = tree.flatten_with_paths(t)
    assert sorted(flat) == ["levels/0/gru/w", "levels/1/gru/w", "seed/b",
                            "seed/w"]
    mod = tree.to_module(t)
    names = {k for k, _ in mod.named_parameters()}
    assert names == {p.replace("/", ".") for p in flat}
    back = tree.from_module(mod)
    assert tree.flatten_with_paths(back).keys() == flat.keys()
    assert isinstance(back["levels"], list)
    # the same paths as the reference's flattener
    jflat = jtree.flatten_with_paths(jax.tree.map(np.asarray, {
        "levels": [{"gru": {"w": np.ones(2)}}, {"gru": {"w": np.zeros(3)}}],
        "seed": {"w": np.ones((1, 2)), "b": np.zeros(2)}}))
    assert set(jflat) == set(flat)


# ------------------------------------------------------------- layers -------

def test_linear_conv_embedding_match_reference():
    rng = np.random.RandomState(0)
    lin = {"w": rng.randn(6, 5).astype(np.float32),
           "b": rng.randn(5).astype(np.float32)}
    x = rng.randn(3, 6).astype(np.float32)
    close(layers.linear(tt(lin), tt(x)), jlayers.linear(lin, jnp.asarray(x)))

    for k, cin, cout in [(3, 4, 7), (1, 4, 6)]:
        conv = {"w": rng.randn(k, k, cin, cout).astype(np.float32),
                "b": rng.randn(cout).astype(np.float32)}
        xi = rng.randn(2, 5, 6, cin).astype(np.float32)
        close(layers.conv2d(tt(conv), tt(xi)),
              jlayers.conv2d(conv, jnp.asarray(xi)))
        valid = layers.conv2d(tt(conv), tt(xi), padding="VALID")
        close(valid, jax.lax.conv_general_dilated(
            jnp.asarray(xi), conv["w"], (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + conv["b"])

    emb = {"emb": rng.randn(5, 4).astype(np.float32)}
    idx = np.array([0, 3, 3, 1], np.int32)
    close(layers.embedding(tt(emb), tt(idx)),
          jlayers.embedding(emb, jnp.asarray(idx)))


@pytest.mark.parametrize("bias", [True, False])
def test_upsample2x_conv3x3_phase_form_matches_reference(bias):
    rng = np.random.RandomState(1)
    p = {"w": rng.randn(3, 3, 4, 6).astype(np.float32)}
    if bias:
        p["b"] = rng.randn(6).astype(np.float32)
    x = rng.randn(2, 5, 4, 4).astype(np.float32)
    ours = layers.upsample2x_conv3x3(tt(p), tt(x))
    assert ours.shape == (2, 10, 8, 6)
    close(ours, jlayers.upsample2x_conv3x3(p, jnp.asarray(x)))
    # and it IS nearest-up followed by a SAME 3×3 conv
    close(ours, jlayers.conv2d(p, jresize.upsample_nearest_2x(
        jnp.asarray(x))), atol=1e-4)


def test_upsample_nearest_matches_reference():
    x = np.random.RandomState(2).randn(2, 3, 5, 4).astype(np.float32)
    ours = resize.upsample_nearest_2x(tt(x))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jresize.upsample_nearest_2x(jnp.asarray(x))))


# --------------------------------------------------------------- norm -------

def _stats(rng, c):
    return {"mean": (0.3 * rng.randn(c)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


@pytest.mark.parametrize("train", [True, False])
def test_bn_matches_reference(train):
    rng = np.random.RandomState(3)
    c = 5
    p = {"scale": rng.randn(c).astype(np.float32),
         "bias": rng.randn(c).astype(np.float32)}
    stats = _stats(rng, c)
    x = (2.0 + 1.5 * rng.randn(4, 3, 3, c)).astype(np.float32)
    y, s = norm.bn(tt(p), tt(stats), tt(x), train)
    jy, js = jnorm.bn(p, stats, jnp.asarray(x), train)
    close(y, jy)
    for k in ("mean", "var"):
        close(s[k], js[k])


@pytest.mark.parametrize("train", [True, False])
def test_cbn_matches_reference(train):
    rng = np.random.RandomState(4)
    c, cond_dim = 6, 7
    p = {"gamma": {"w": (0.3 * rng.randn(cond_dim, c)).astype(np.float32)},
         "beta": {"w": (0.3 * rng.randn(cond_dim, c)).astype(np.float32)}}
    stats = _stats(rng, c)
    x = (1.0 + rng.randn(4, 3, 3, c)).astype(np.float32)
    cond = rng.randn(4, cond_dim).astype(np.float32)
    y, s = norm.cbn(tt(p), tt(stats), tt(x), tt(cond), train)
    jy, js = jnorm.cbn(p, stats, jnp.asarray(x), jnp.asarray(cond), train)
    close(y, jy)
    for k in ("mean", "var"):
        close(s[k], js[k])


def test_bn_moments_are_f32_and_running_var_biased():
    x = torch.tensor([[1.0], [3.0]], dtype=torch.bfloat16)
    _, s = norm.bn({"scale": torch.ones(1), "bias": torch.zeros(1)},
                   {"mean": torch.zeros(1), "var": torch.zeros(1)}, x, True,
                   momentum=1.0)
    assert s["var"].dtype == torch.float32
    assert float(s["var"]) == 1.0          # biased: ((1-2)² + (3-2)²) / 2


# ------------------------------------------------------- spectral norm -------

def _sn_tree(rng):
    # random (not orthogonal) kernels: u is not a fixed point
    return {"conv": {"w": rng.randn(3, 3, 4, 5).astype(np.float32),
                     "b": rng.randn(5).astype(np.float32)},
            "embed": {"emb": rng.randn(6, 7).astype(np.float32)},
            "lin": [{"w": rng.randn(8, 3).astype(np.float32)}],
            "gamma": np.float32(0.5)}


@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("n_iter", [1, 3])
def test_sn_normalize_matches_reference(update, n_iter):
    rng = np.random.RandomState(5)
    params = _sn_tree(rng)
    u = jsn.sn_init(jax.random.PRNGKey(0), params)
    assert set(u) == {"conv/w", "embed/emb", "lin/0/w"}
    jp, ju = jsn.sn_normalize(params, u, update=update, n_iter=n_iter)
    p, nu = sn.sn_normalize(tt(params), {k: tt(v) for k, v in u.items()},
                            update=update, n_iter=n_iter)
    jflat, flat = jtree.flatten_with_paths(jp), tree.flatten_with_paths(p)
    assert jflat.keys() == flat.keys()
    for k in flat:
        close(flat[k], jflat[k])
    assert nu.keys() == ju.keys()
    for k in nu:
        close(nu[k], ju[k])
        if not update:
            np.testing.assert_array_equal(nu[k].numpy(), np.asarray(u[k]))
    for k, w in jtree.flatten_with_paths(params).items():
        if k in u:
            s, _ = sn.sigma_and_update(tt(w), tt(u[k]), n_iter)
            js, _ = jsn.sigma_and_update(jnp.asarray(w), u[k], n_iter)
            close(s, js)


def test_sn_normalize_compute_dtype_casts_every_leaf():
    rng = np.random.RandomState(6)
    params = _sn_tree(rng)
    u = jsn.sn_init(jax.random.PRNGKey(1), params)
    jp, _ = jsn.sn_normalize(params, u, update=False,
                             compute_dtype=jnp.bfloat16)
    p, _ = sn.sn_normalize(tt(params), {k: tt(v) for k, v in u.items()},
                           update=False, compute_dtype=torch.bfloat16)
    jflat, flat = jtree.flatten_with_paths(jp), tree.flatten_with_paths(p)
    for k in flat:
        assert flat[k].dtype == torch.bfloat16, k
        # same f32 value rounded once: equal up to one bf16 ulp where σ's
        # last f32 bit lands on a rounding boundary
        close(flat[k], np.asarray(jflat[k], np.float32), atol=ATOL,
              rtol=2.0 ** -8)


def test_sn_init_draws_unit_u_in_out_space():
    params = tt(_sn_tree(np.random.RandomState(7)))
    u = sn.sn_init(torch.Generator().manual_seed(0), params)
    assert {k: tuple(v.shape) for k, v in u.items()} == {
        "conv/w": (5,), "embed/emb": (7,), "lin/0/w": (3,)}
    for v in u.values():
        assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-6
