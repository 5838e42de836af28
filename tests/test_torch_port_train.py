"""The train step, port vs dvdgan_tpu: one `train_step` from the same state
(carried across with `interop`) and the same random draws (the reference's,
fed through the port's draw hook in its key-split order) gives the same
losses and the same new state; Adam and EMA against optax and the
reference; the whole train state across `interop` bitwise; the train CLI
on the CPU.

f32, JAX at `highest` matmul precision (conftest). Losses atol 1e-4; state
leaves atol 1e-5 (Adam nu rtol 1e-3); params atol 1e-6 where |grad| ≥ 1e-4
and within 2·lr elsewhere — Adam's first update is about lr·sign(g), so a
near-zero gradient whose sign the summation order flips moves its param by
up to 2·lr without a fault. Adam mu is the gradient itself (β1 = 0), whose
entries reach ~17 here: it is held at 5e-6 × max|mu| of its model, since
f32 sums of thousands of terms taken in another order differ by ~1e-6 of
that scale (measured ≤ 1.2e-6), on entries that are analytically zero too
(the conv biases ahead of a BN).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from dvdgan_tpu.core import tree as jtree
from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu_torch import cli, interop
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.utils.logging import parse_step_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G_KW = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16)
DS_KW = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
DT_KW = dict(img_size=32, n_frames=4, ch=8, n_classes=5)
TC_KW = dict(d_steps=2, ema_start=0)
B = 2
TRAIN_FLAGS = ["--img_size", "32", "--n_frames", "4", "--ch", "8",
               "--d_ch", "8", "--n_classes", "5", "--emb_dim", "16",
               "--attn_res", "16", "--k_frames", "2", "--batch_size", "2",
               "--d_steps", "2", "--ema_start", "0", "--bf16", "0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it:
    the suite runs six workers on the machine's cores, where torch's default
    of a thread a core oversubscribes them (`test_torch_port_fp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def flat_np(jax_tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in
            jtree.flatten_with_paths(jax_tree).items()}


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
    return real, np.array([1, 4], np.int32)


@pytest.fixture(scope="module")
def one_step():
    """(reference state, reference new state, reference metrics, the port's
    new state and metrics, the port's G gradient magnitude per leaf)."""
    jstate0 = reference_state(0)
    real, y = batch(1)
    key = jax.random.PRNGKey(2)
    f = jax.jit(functools.partial(
        jstep.train_step, g_cfg=JGConfig(**G_KW), ds_cfg=JDSConfig(**DS_KW),
        dt_cfg=JDTConfig(**DT_KW), tc=jstate.TrainConfig(**TC_KW)))
    jnew, jmetrics = f(jstate0, jnp.asarray(real), jnp.asarray(y), key)

    state0 = interop.load_train_state(flat_np(jstate0))
    draws = ReferenceDraws(key, B, G_KW["z_dim"], G_KW["n_frames"],
                           DS_KW["k_frames"])
    new, metrics = step.train_step(
        state0, torch.from_numpy(real), torch.from_numpy(y).long(), draws,
        GConfig(**G_KW), DSConfig(**DS_KW), DTConfig(**DT_KW),
        train_state.TrainConfig(**TC_KW, log_grad_norms=True))
    return flat_np(jstate0), flat_np(jnew), jmetrics, new, metrics


LOSSES = ("d_loss", "d_loss_s", "d_loss_t", "g_loss")


def test_train_step_losses_match_reference(one_step):
    _, _, jmetrics, _, metrics = one_step
    assert set(metrics) == {*LOSSES, "d_grad_norm", "g_grad_norm"}
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and v.dim() == 0
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=1e-4, err_msg=k)


def test_grad_norms_match_reference(one_step):
    """With β1 = 0 Adam's new mu is the gradient: each norm equals the
    global norm of the reference's new mu trees (D: DS and DT together, the
    last D step's)."""
    _, ref, _, _, metrics = one_step

    def norm(models):
        return np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                           for k, v in ref.items()
                           if k.split("/opt/0/mu/")[0] in models
                           and "/opt/0/mu/" in k))

    np.testing.assert_allclose(float(metrics["d_grad_norm"]),
                               norm(("ds", "dt")), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["g_grad_norm"]), norm(("g",)),
                               rtol=1e-4)


def test_train_step_state_matches_reference(one_step):
    old, ref, _, new, _ = one_step
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
            np.testing.assert_allclose(got, want, atol=5e-6 * mu_scale[model],
                                       rtol=0, err_msg=k)
        else:
            rtol = 1e-3 if "/opt/0/nu/" in k else 0
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=rtol,
                                       err_msg=k)
    # the state did change, and the gradient check covers most params
    assert n_small < 0.2 * n_params
    for k in ("g/sn_u/levels/0/gru/gates_h/w", "ds/sn_u/blocks/0/conv1/w",
              "dt/sn_u/blocks/0/conv1/w", "g/stats/out_bn/mean"):
        assert not np.allclose(ref[k], old[k]), k
    assert int(ours["step"]) == int(old["step"]) + 1


def test_adam_matches_optax_over_steps():
    rng = np.random.RandomState(0)
    params = {"a": {"w": rng.randn(3, 4).astype(np.float32)},
              "b": [rng.randn(5).astype(np.float32)]}
    opt = optax.adam(5e-4, b1=0.0, b2=0.999)
    jp, js = jax.tree.map(jnp.asarray, params), opt.init(params)
    tp = tree.tree_map(torch.from_numpy, params)
    ts = train_state.adam_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params)
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = train_state.adam_update(tree.tree_map(torch.from_numpy, g),
                                         ts, tp, 5e-4, 0.0, 0.999)
    assert int(ts["count"]) == int(js[0].count) == 3
    for path, v in tree.flatten_with_paths(tp).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jtree.flatten_with_paths(jp)[path]), atol=1e-7, rtol=0)
    for name in ("mu", "nu"):
        for path, v in tree.flatten_with_paths(ts[name]).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(
                jtree.flatten_with_paths(getattr(js[0], name))[path]),
                atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("step_no,start", [(0, 2), (2, 2), (7, 2)])
def test_ema_matches_reference(step_no, start):
    rng = np.random.RandomState(step_no)
    ema = {"w": rng.randn(6).astype(np.float32)}
    p = {"w": rng.randn(6).astype(np.float32)}
    ref = jstate.ema_update(jax.tree.map(jnp.asarray, ema),
                            jax.tree.map(jnp.asarray, p), 0.9999,
                            jnp.int32(step_no), start)
    ours = train_state.ema_update(tree.tree_map(torch.from_numpy, ema),
                                  tree.tree_map(torch.from_numpy, p), 0.9999,
                                  torch.tensor(step_no, dtype=torch.int32),
                                  start)
    np.testing.assert_allclose(ours["w"].numpy(), np.asarray(ref["w"]),
                               atol=1e-7, rtol=0)
    if step_no < start:     # copy-through
        np.testing.assert_array_equal(ours["w"].numpy(), p["w"])


def test_train_state_round_trips_bitwise(tmp_path):
    """JAX create -> numpy -> port -> numpy is bitwise, optax layout
    included, and the port's npz loads back into the reference's tree."""
    s = jstate.create(jax.random.PRNGKey(3), JGConfig(**G_KW),
                      JDSConfig(**DS_KW), JDTConfig(**DT_KW),
                      jstate.TrainConfig(**TC_KW))
    flat = flat_np(s)
    port = interop.load_train_state(flat)
    interop.save_train_state_npz(str(tmp_path / "s.npz"), port)
    again = interop.train_state_to_flat(
        interop.load_train_state_npz(str(tmp_path / "s.npz")))
    assert again.keys() == flat.keys()
    for k, v in again.items():
        assert v.dtype == flat[k].dtype, k
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    with np.load(tmp_path / "s.npz") as f:
        paths = [jtree.path_str(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(s)[0]]
        back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(s),
                                            [f[p] for p in paths])
    assert isinstance(back["g"]["opt"][0], optax.ScaleByAdamState)
    assert jax.tree_util.tree_structure(back) == (
        jax.tree_util.tree_structure(s))


def test_port_state_paths_match_reference():
    ours = interop.train_state_to_flat(train_state.create(
        0, GConfig(**G_KW), DSConfig(**DS_KW), DTConfig(**DT_KW)))
    ref = flat_np(jstate.create(
        jax.random.PRNGKey(0), JGConfig(**G_KW), JDSConfig(**DS_KW),
        JDTConfig(**DT_KW), jstate.TrainConfig(**TC_KW)))
    assert ours.keys() == ref.keys()
    for k, v in ours.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k


def test_train_cli_on_cpu_writes_state(tmp_path):
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "dvdgan_tpu_torch", "--mode", "train",
         "--device", "cpu", "--total_step", "2", "--log_step", "1",
         "--model_save_step", "2", *TRAIN_FLAGS, "--out_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    lines = [parse_step_line(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("step ")]
    assert [n for n, _ in lines] == [1, 2]
    launches = {f"{k}_launches" for k in ("k1", "k2", "k3", "k5a", "k5b",
                                          "k6a", "k6b")}
    for _, fields in lines:
        assert set(fields) == {*LOSSES, "steps/s", "loader_wait_ms"} | launches
        assert all(np.isfinite(fields[k]) for k in LOSSES)
        # CPU tensors take the plain versions: no kernel launches
        assert {fields[k] for k in launches} == {0}
    saved = out / "checkpoints" / "2" / "train_state.npz"
    state = interop.load_train_state_npz(str(saved))
    assert int(state["step"]) == 2
    with np.load(saved) as f:
        assert all(np.isfinite(f[k]).all() for k in f.files)

    # a run started from the written state takes one more step
    again = cli.main(["--mode", "train", "--device", "cpu", "--total_step",
                      "3", "--model_save_step", "1", *TRAIN_FLAGS,
                      "--out_dir", str(tmp_path / "b"), "--weights",
                      str(saved)])
    assert int(again["step"]) == 3
    assert (tmp_path / "b" / "checkpoints" / "3" / "train_state.npz").exists()


@pytest.mark.parametrize("flags,match", [
    # time-axis CP needs as many ranks as shards: one CPU launch has one
    (["--time_shards", "2"], "needs at least that many devices"),
    # --n_devices starts a launch's ranks; --multihost's launcher does
    (["--n_devices", "2", "--multihost", "1"], "launcher starts"),
], ids=["flags0-item 6", "flags2-item 6"])
def test_train_cli_refuses_what_is_not_ported(flags, match, tmp_path):
    """Queue 1 item 6 is ported (`tests/test_torch_port_parallel.py`); the
    CLI still refuses the multi-rank flags it cannot honour, before it
    writes anything."""
    with pytest.raises(ValueError, match=match):
        cli.main(["--mode", "train", "--device", "cpu", *TRAIN_FLAGS, *flags,
                  "--out_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
