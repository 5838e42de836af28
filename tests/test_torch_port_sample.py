"""The whole EMA-G sampling path, port vs dvdgan_tpu: JAX train/step.sample
-> np.savez -> interop.load_generator_state -> the port's sample, f32 at
atol 1e-4; the sample CLI on the CPU; and the port's import boundary (no
jax, nothing of dvdgan_tpu).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.core import tree as jtree
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.models import generator as jgen
from dvdgan_tpu.ops import spectral_norm as jsn
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu_torch import cli, interop
from dvdgan_tpu_torch.models import GConfig
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.train import step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16)
TINY_FLAGS = ["--img_size", "32", "--n_frames", "4", "--ch", "8",
              "--n_classes", "5", "--emb_dim", "16", "--attn_res", "16",
              "--n_samples", "2", "--bf16", "0", "--device", "cpu"]


def reference_state(kw: dict, seed: int) -> dict[str, np.ndarray]:
    """A dvdgan_tpu G state, flattened the reference's way. Weights are
    perturbed off the orthogonal init (which makes every SN u a fixed
    point), attention γ is non-zero and the BN stats are non-trivial."""
    params, stats = jgen.init(jax.random.PRNGKey(seed), JGConfig(**kw))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + np.float32(0.05) * np.asarray(
            rng.randn(*a.shape), np.float32), params)
    for name, g in (("spatial", 0.6), ("temporal", -0.5)):
        params["attn"][name]["gamma"] = np.float32(g)
    stats = jax.tree.map(np.asarray, stats)
    for s in jax.tree.leaves(stats, is_leaf=lambda x: isinstance(x, dict)
                             and "mean" in x):
        c = s["mean"].shape[0]
        s["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        s["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sn_u = jsn.sn_init(jax.random.PRNGKey(seed + 1), params)
    flat = jtree.flatten_with_paths(
        {"g_ema": params, "g": {"stats": stats, "sn_u": sn_u}})
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.mark.parametrize("kw", [
    TINY,
    # 64px: 4 levels whose GResBlocks change width (1×1 skip convs)
    dict(img_size=64, n_frames=2, ch=4, z_dim=120, n_classes=5, emb_dim=16,
         attn_res=32),
], ids=["32px", "64px"])
def test_sample_matches_reference_through_npz(kw, tmp_path):
    flat = reference_state(kw, seed=0)
    path = str(tmp_path / "g_state.npz")
    np.savez(path, **flat)
    with np.load(path) as f:
        state = interop.load_generator_state({k: f[k] for k in f.files})

    rng = np.random.RandomState(1)
    z = rng.randn(3, kw["z_dim"]).astype(np.float32)
    y = np.array([0, 4, 2], np.int32)
    jcfg = JGConfig(**kw)
    ref = jax.jit(jstep.sample, static_argnames=("g_cfg",))(
        _unflat(flat, "g_ema/"), _unflat(flat, "g/stats/"), _sn_u(flat),
        jnp.asarray(z),
        jnp.asarray(y), g_cfg=jcfg)
    ours = step.sample(*state.trees(), torch.from_numpy(z),
                       torch.from_numpy(y).long(), GConfig(**kw))
    assert ours.shape == ref.shape == (3, kw["n_frames"], kw["img_size"],
                                       kw["img_size"], 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)

    # the port's own npz round-trips the state exactly
    interop.save_state_npz(str(tmp_path / "port.npz"), state)
    again = interop.load_state_npz(str(tmp_path / "port.npz"))
    assert interop.generator_state_to_flat(again).keys() == flat.keys()
    for k, v in interop.generator_state_to_flat(again).items():
        np.testing.assert_array_equal(v, flat[k].astype(np.float32))


def _unflat(flat, prefix):
    from dvdgan_tpu_torch.core import tree
    return tree.unflatten({k[len(prefix):]: jnp.asarray(v)
                           for k, v in flat.items() if k.startswith(prefix)})


def _sn_u(flat):
    return {k[len("g/sn_u/"):]: jnp.asarray(v) for k, v in flat.items()
            if k.startswith("g/sn_u/")}


def test_generator_state_paths_match_reference():
    kw = TINY
    state = GeneratorState.create(GConfig(**kw), seed=0)
    ref = reference_state(kw, seed=0)
    assert interop.generator_state_to_flat(state).keys() == ref.keys()
    for k, v in interop.generator_state_to_flat(state).items():
        assert v.shape == ref[k].shape, k


def test_sample_cli_writes_clips_on_cpu(tmp_path):
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "dvdgan_tpu_torch", "--mode", "sample",
         *TINY_FLAGS, "--out_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    clips = np.load(out / "samples.npy")
    assert clips.shape == (2, 4, 32, 32, 3) and clips.dtype == np.float32
    assert np.isfinite(clips).all() and np.abs(clips).max() <= 1.0

    # --weights: the same clips from the seeded init saved to an npz
    interop.save_state_npz(str(tmp_path / "w.npz"),
                           GeneratorState.create(GConfig(**TINY), seed=0))
    again = cli.main(["--mode", "sample", *TINY_FLAGS, "--out_dir",
                      str(tmp_path / "again"), "--weights",
                      str(tmp_path / "w.npz")])
    np.testing.assert_allclose(again, clips, atol=1e-6)


@pytest.mark.parametrize("mode", ["sample", "train", "eval"])
def test_cli_default_device_refuses_without_a_card(mode, tmp_path,
                                                    monkeypatch):
    """The default device is the card: without one the CLI raises rather
    than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--mode", mode, *flags, "--out_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dvdgan_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'dvdgan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dvdgan_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('dvdgan_tpu_torch')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert len(imported) >= 20
    # the training slice's modules are inside the boundary too
    assert {f"dvdgan_tpu_torch.{m}" for m in (
        "kernels.convgru_bwd", "models.discriminator", "ops.losses",
        "train.state", "train.step", "cli", "interop")} <= imported
