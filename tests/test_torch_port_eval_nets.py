"""The port's scoring networks (`dvdgan_tpu_torch/eval/{i3d,inception,c3d}.py`)
against the reference's (`dvdgan_tpu/eval/`), on the CPU in f32.

The weights cross only as the reference's `save_npz` writes them: its
`init`, with every BatchNorm's moments and affine parameters perturbed
(seeded) so that eps and the order of the BN arithmetic show, saved, then
read by the port's `load_npz`. Inputs are the same numpy arrays; the
reference's apply is jitted once per network and shape. Tolerance: max
|port − reference| ≤ 1e-4 × max |reference| per output (`test_eval_twins`'s
limit for its twins). Nothing runs at 224² or 299² here: I3D at 32² and
16², Inception-v3 at 75² (the least its VALID stem takes), C3D at 112².
Also: the bilinear resize against `jax.image.resize` in both directions,
C3D's 16-frame windowing, and `load_npz` refusing a missing, an unknown
and a misshapen key for each network.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.eval import c3d as jc3d
from dvdgan_tpu.eval import features as jfeatures
from dvdgan_tpu.eval import i3d as ji3d
from dvdgan_tpu.eval import inception as jinception
from dvdgan_tpu_torch.eval import c3d, features, i3d, inception, layers

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it:
    the suite runs six workers on the machine's cores, where torch's
    default of a thread a core oversubscribes them (a 2 s CPU test took
    two minutes beside five busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(ours, ref, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, what
    gap = np.abs(ours - ref).max()
    assert gap <= REL * np.abs(ref).max(), (what, gap, np.abs(ref).max())


def perturbed(params: dict, seed: int) -> dict:
    """The reference's params with every BN vector moved off identity."""
    rng = np.random.RandomState(seed)
    out = {k: np.asarray(v) for k, v in params.items()}
    for k, v in out.items():
        n = v.shape
        if k.endswith("/bn/mean"):
            out[k] = rng.normal(0, 0.2, n).astype(np.float32)
        elif k.endswith("/bn/var"):
            out[k] = rng.uniform(0.25, 1.75, n).astype(np.float32)
        elif k.endswith("/bn/scale"):
            out[k] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        elif k.endswith("/bn/offset"):
            out[k] = rng.normal(0, 0.1, n).astype(np.float32)
    return out


def carried(mod, params: dict, path) -> str:
    mod.save_npz(str(path), params)
    return str(path)


def video(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def i3d_npz(tmp_path_factory):
    ref = perturbed(ji3d.init(jax.random.PRNGKey(1)), 2)
    return ref, carried(ji3d, ref, tmp_path_factory.mktemp("i3d") / "w.npz")


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    ref = perturbed(jinception.init(jax.random.PRNGKey(3)), 4)
    return ref, carried(jinception, ref,
                        tmp_path_factory.mktemp("iv3") / "w.npz")


@pytest.fixture(scope="module")
def c3d_npz(tmp_path_factory):
    ref = {k: np.asarray(v) for k, v in jc3d.init(jax.random.PRNGKey(5)
                                                  ).items()}
    rng = np.random.RandomState(6)
    for k in ref:                       # biases off zero too
        if k.endswith("/b"):
            ref[k] = rng.normal(0, 0.05, ref[k].shape).astype(np.float32)
    mean = rng.uniform(80, 120, (16, 112, 112, 3)).astype(np.float32)
    path = tmp_path_factory.mktemp("c3d") / "w.npz"
    jc3d.save_npz(str(path), ref, input_mean=mean, input_bgr=True)
    return ref, mean, str(path)


def both_heads(apply, first: str, second: str, **kw):
    """One jitted reference call that returns two features of one
    forward (XLA shares the trunk)."""
    body = apply.__wrapped__
    return jax.jit(lambda p, v: (body(p, v, first, **kw),
                                 body(p, v, second, **kw)))


# ------------------------------------------------------------------- resize
@pytest.mark.parametrize("src,dst", [(64, 224), (64, 299), (64, 112),
                                     (128, 112), (100, 64)])
def test_resize_matches_jax_image_resize(src, dst):
    """Stretch and shrink (128→112 and 100→64 are non-integer shrinks,
    which JAX antialiases)."""
    v = video((2, 2, src, src, 3), src + dst)
    ref = jax.image.resize(jnp.asarray(v), (2, 2, dst, dst, 3), "bilinear")
    ours = layers.resize_frames(torch.from_numpy(v), dst)
    assert_close(ours.numpy(), ref, f"{src}->{dst}")


# ---------------------------------------------------------------------- I3D
@pytest.mark.parametrize("shape", [(2, 16, 32, 32, 3),    # T' = 2: a mean
                                   (1, 24, 16, 16, 3)],   # T' = 3: weighted
                         ids=["t2", "t3"])
def test_i3d_matches_reference(i3d_npz, shape):
    ref_params, path = i3d_npz
    v = video(shape, 7)
    ref_logits, ref_pool = both_heads(ji3d.apply, "logits", "avgpool",
                                      resize=None)(ref_params, v)
    params = i3d.load_npz(path)
    x = torch.from_numpy(v)
    with layers.exact_f32():
        assert_close(i3d.apply(params, x, "logits", None), ref_logits,
                     "logits")
        assert_close(i3d.apply(params, x, "avgpool", None), ref_pool,
                     "avgpool")


# ------------------------------------------------------------- Inception-v3
def test_inception_matches_reference(inception_npz):
    ref_params, path = inception_npz
    v = video((2, 75, 75, 3), 8)
    ref_pool, ref_logits = both_heads(jinception.apply, "pool", "logits",
                                      resize=None)(ref_params, v)
    params = inception.load_npz(path)
    x = torch.from_numpy(v)
    with layers.exact_f32():
        assert_close(inception.apply(params, x, "pool", None), ref_pool,
                     "pool")
        assert_close(inception.apply(params, x, "logits", None), ref_logits,
                     "logits")


# ---------------------------------------------------------------------- C3D
def test_c3d_matches_reference_with_mean_cube_and_bgr(c3d_npz):
    ref_params, mean, path = c3d_npz
    v = video((1, 16, 112, 112, 3), 9)
    ref = jc3d.apply(ref_params, jnp.asarray(v), "logits", None,
                     jnp.asarray(mean), True)
    params, input_mean, input_bgr = c3d.load_npz(path)
    assert input_bgr and input_mean.shape == (16, 112, 112, 3)
    with layers.exact_f32():
        ours = c3d.apply(params, torch.from_numpy(v), "logits", None,
                         input_mean, input_bgr)
    assert_close(ours, ref, "logits")


@pytest.mark.parametrize("t", [8, 24])
def test_c3d_features_window_clips_as_the_reference(c3d_npz, t):
    """T 8 is loop-tiled to 16, T 24 cut to its centre 16; both then
    stretched from 32² to 112²; the npz's mean cube and BGR order apply."""
    _, _, path = c3d_npz
    ref = jfeatures.C3DFeatures(path)
    ours = features.C3DFeatures(path, device="cpu")
    v = video((1, t, 32, 32, 3), t)
    assert_close(ours(v), ref(v), f"T {t}")


# ------------------------------------------------------------------ load_npz
def _broken(expected: dict, fault: str) -> dict:
    """Zero int8 arrays at the topology's shapes (the check reads shapes
    only), with one fault."""
    arrays = {k: np.zeros(s, np.int8) for k, s in expected.items()}
    first = sorted(arrays)[0]
    if fault == "missing":
        del arrays[first]
    elif fault == "unknown":
        arrays["not_a_unit/w"] = np.zeros((1,), np.int8)
    else:
        arrays[first] = np.zeros((2, 3), np.int8)
    return arrays


@pytest.mark.parametrize("fault,says", [("missing", r"missing \(1\)"),
                                        ("unknown", r"unknown \(1\)"),
                                        ("misshapen",
                                         r"shape mismatches \(1\)")])
@pytest.mark.parametrize("net", ["i3d", "inception", "c3d"])
def test_load_npz_refuses_a_faulty_file(net, fault, says, tmp_path):
    mod = {"i3d": i3d, "inception": inception, "c3d": c3d}[net]
    path = str(tmp_path / "w.npz")
    np.savez(path, **_broken(mod.param_shapes(), fault))
    with pytest.raises(ValueError, match=says):
        mod.load_npz(path)
