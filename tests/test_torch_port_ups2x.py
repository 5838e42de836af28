"""The fused-upsample route (K5a/K5b), port vs dvdgan_tpu, on the CPU.

The same numpy-seeded inputs go through the JAX function (its Pallas kernels
interpreted, as `tests/test_kernels.py` runs them) and the port's plain
versions and entries:

  * `ups2x_reference` vs `kups.ups2x(..., interpret=True, force_bh)`: f32
    atol 1e-5; bf16 atol 2e-2 (one bf16 ulp at these magnitudes) with the
    count of differing elements printed (both accumulate in f32 and round
    once, so they differ only where the f32 sums' order straddles a
    rounding boundary);
  * `ups2x_bwd_reference` and the autograd Function's gradients (both
    backward modes) vs `jax.vjp` through the interpreted kernel with
    `pallas_bwd` True and False: f32 atol 1e-4;
  * `upsample2x_conv3x3(p, x, fused=m)` vs the reference's under
    DVDGAN_UPS_PALLAS=m, values and gradients to w, b and x (atol 1e-5 /
    1e-4), and `fused=m` equal to `fused="off"` (f32 atol 1e-5);
  * the slice as a whole at the repo's test scale (img 32, T 4, ch 8, f32):
    `sample` and one `train_step` with `ups_fused="full"` vs the JAX ones
    traced under DVDGAN_UPS_PALLAS=full, at the tolerances of
    `test_torch_port_sample.py` (atol 1e-4) and `test_torch_port_train.py`
    (losses 1e-4, Adam mu 5e-6 × max|mu|);
  * one grad_accum=2 + remat step with "full" equal to the same step with
    "off" within 1e-5 × max|mu|, the fused forward entered once per level
    per G forward (none from the remat backward);
  * a state saved under "off" loads and samples under "full" (the route
    changes no tree).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import ups2x_fused as kups
from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.ops import layers as jlayers
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu_torch import cli, interop, kernels
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.kernels import ups2x_fused
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig, generator
from dvdgan_tpu_torch.ops import layers
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.utils.config import parse_config
from dvdgan_tpu_torch.utils.logging import parse_step_line

from test_torch_port_longclip import ReferenceDraws, flat_np, reference_state

G_KW = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16)
DS_KW = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
DT_KW = dict(img_size=32, n_frames=4, ch=8, n_classes=5)
TC_KW = dict(d_steps=2, ema_start=0)
SHAPES = [(2, 4, 6, 8, 4), (3, 8, 8, 16, 8)]       # N, H, W, Cin, Cout
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it:
    the suite runs six workers on the machine's cores, where torch's default
    of a thread a core oversubscribes them (`test_torch_port_fp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ups_inputs(seed, n, h, w, cin, cout):
    """(wall, xp, g) as f32 numpy arrays; xp zero-padded."""
    rng = np.random.RandomState(seed)
    wall = (0.3 * rng.randn(4 * cin, 4 * cout)).astype(np.float32)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    g = rng.randn(n, 2 * h, 2 * w, cout).astype(np.float32)
    return wall, xp, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("force_bh", [None, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ups2x_reference_matches_interpreted_kernel(shape, force_bh, dtype):
    wall, xp, _ = ups_inputs(0, *shape)
    ref = kups.ups2x(jnp.asarray(wall, JDT[dtype]), jnp.asarray(xp, JDT[dtype]),
                     True, True, force_bh)
    ours = ups2x_fused.ups2x_reference(
        torch.from_numpy(wall).to(TDT[dtype]),
        torch.from_numpy(xp).to(TDT[dtype]))
    n, h, w, _, cout = shape
    assert ours.shape == ref.shape == (n, 2 * h, 2 * w, cout)
    assert ours.dtype == TDT[dtype]
    got, want = ours.float().numpy(), np.asarray(ref, np.float32)
    if dtype == "bfloat16":
        print(f"\nbf16 elements that differ from the interpreted kernel: "
              f"{int((got != want).sum())} of {got.size}")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("pallas_bwd", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ups2x_gradients_match_interpreted_kernel(shape, pallas_bwd):
    wall, xp, g = ups_inputs(1, *shape)
    _, pull = jax.vjp(lambda a, b: kups.ups2x(a, b, pallas_bwd, True, 2),
                      jnp.asarray(wall), jnp.asarray(xp))
    dwall_ref, dxp_ref = (np.asarray(a) for a in pull(jnp.asarray(g)))

    dwall, dxp = ups2x_fused.ups2x_bwd_reference(
        torch.from_numpy(wall), torch.from_numpy(xp), torch.from_numpy(g))
    assert dwall.dtype == dxp.dtype == torch.float32
    np.testing.assert_allclose(dwall.numpy(), dwall_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dxp.numpy(), dxp_ref, rtol=0, atol=1e-4)

    # the entry under autograd, in the backward mode that matches
    tw = torch.from_numpy(wall).requires_grad_(True)
    tx = torch.from_numpy(xp).requires_grad_(True)
    out = ups2x_fused.ups2x(tw, tx, kernel_bwd=pallas_bwd)
    gw, gx = torch.autograd.grad(out, (tw, tx), torch.from_numpy(g))
    np.testing.assert_allclose(gw.numpy(), dwall_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), dxp_ref, rtol=0, atol=1e-4)


def test_ups2x_bf16_gradients_are_cast_once():
    """In bf16 the Function's gradients are the f32 ones of the plain
    backward, rounded once (the reference's `_vjp_bwd`)."""
    wall, xp, g = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in ups_inputs(2, 2, 4, 4, 8, 4))
    dwall, dxp = ups2x_fused.ups2x_bwd_reference(wall, xp, g)
    tw, tx = wall.clone().requires_grad_(True), xp.clone().requires_grad_(True)
    gw, gx = torch.autograd.grad(ups2x_fused.ups2x(tw, tx), (tw, tx), g)
    assert gw.dtype == gx.dtype == torch.bfloat16
    assert torch.equal(gw, dwall.to(torch.bfloat16))
    assert torch.equal(gx, dxp.to(torch.bfloat16))


def test_ups2x_entry_checks_and_counts():
    wall, xp, g = (torch.from_numpy(a) for a in ups_inputs(3, 2, 4, 4, 8, 4))
    before = (ups2x_fused.ups2x.launches, ups2x_fused.ups2x_bwd.launches)
    out = ups2x_fused.ups2x(wall, xp)
    assert out.grad_fn is None and out.shape == (2, 8, 8, 4)
    with torch.no_grad():           # no graph to build: nothing is saved
        assert ups2x_fused.ups2x(wall.requires_grad_(True), xp).grad_fn is None
    ups2x_fused.ups2x_bwd(wall.detach(), xp, g)
    # the counters count kernel launches: none on CPU tensors
    assert (ups2x_fused.ups2x.launches,
            ups2x_fused.ups2x_bwd.launches) == before
    with pytest.raises(ValueError, match="does not fit"):
        ups2x_fused.ups2x(wall.detach()[:-4], xp)
    with pytest.raises(ValueError, match="does not fit"):
        ups2x_fused.ups2x(wall.detach()[:, :-1], xp)
    with pytest.raises(ValueError, match="want wall"):
        ups2x_fused.ups2x(wall.detach(), xp[0])
    with pytest.raises(ValueError, match="g has shape"):
        ups2x_fused.ups2x_bwd(wall.detach(), xp, g[:, :-1])
    with pytest.raises(ValueError, match="no kernel for device"):
        ups2x_fused.ups2x(wall.detach().to("meta"), xp.to("meta"))


# ------------------------------------------------------------ the layer ----

def layer_inputs(seed, n=2, h=8, w=8, cin=8, cout=4):
    rng = np.random.RandomState(seed)
    p = {"w": (0.2 * rng.randn(3, 3, cin, cout)).astype(np.float32),
         "b": (0.1 * rng.randn(cout)).astype(np.float32)}
    x = rng.randn(n, h, w, cin).astype(np.float32)
    up = rng.randn(n, 2 * h, 2 * w, cout).astype(np.float32)
    return p, x, up


def torch_layer(p, x, up, fused):
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = layers.upsample2x_conv3x3(tp, tx, fused)
    grads = torch.autograd.grad((out * torch.from_numpy(up)).sum(),
                                (tp["w"], tp["b"], tx))
    return out.detach().numpy(), [a.numpy() for a in grads]


@pytest.mark.parametrize("mode", ["fwd", "full"])
def test_upsample2x_conv3x3_routes_match_reference(monkeypatch, mode):
    p, x, up = layer_inputs(4)
    hits = []
    fwd = kups._fwd_pallas
    monkeypatch.setattr(kups, "_fwd_pallas",
                        lambda *a, **k: hits.append(1) or fwd(*a, **k))
    monkeypatch.setenv("DVDGAN_UPS_PALLAS", mode)

    def loss(p, x):
        out = jlayers.upsample2x_conv3x3(p, x)
        return (out * jnp.asarray(up)).sum(), out

    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert hits, "the reference did not take its fused route"

    out, (gw, gb, gxx) = torch_layer(p, x, up, mode)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gw, np.asarray(gp["w"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, np.asarray(gp["b"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gxx, np.asarray(gx), rtol=0, atol=1e-4)

    off, off_grads = torch_layer(p, x, up, "off")
    np.testing.assert_allclose(out, off, rtol=0, atol=1e-5)
    for a, b in zip((gw, gb, gxx), off_grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_upsample2x_conv3x3_refuses_an_unknown_route():
    p, x, _ = layer_inputs(5)
    with pytest.raises(ValueError, match="fused must be one of"):
        layers.upsample2x_conv3x3({k: torch.from_numpy(v)
                                   for k, v in p.items()},
                                  torch.from_numpy(x), "on")


def test_ups_fused_flag_reaches_gconfig():
    """--ups_fused is carried by Config and GConfig (no environment
    variable); its default is the unfused route."""
    assert parse_config([]).g_config().ups_fused == "off"
    for mode in ("off", "fwd", "full"):
        cfg = parse_config(["--preset", "kinetics_256_48f", "--ups_fused",
                            mode])
        assert cfg.ups_fused == cfg.g_config().ups_fused == mode
    with pytest.raises(SystemExit):
        parse_config(["--ups_fused", "on"])


# ------------------------------------------------- the slice as a whole ----

@pytest.fixture
def fused_reference(monkeypatch):
    """The reference traced with its fused route on: sets
    DVDGAN_UPS_PALLAS=full and returns the list its fused forward appends
    to on every trace through it."""
    hits = []
    fwd = kups._fwd_pallas
    monkeypatch.setattr(kups, "_fwd_pallas",
                        lambda *a, **k: hits.append(1) or fwd(*a, **k))
    monkeypatch.setenv("DVDGAN_UPS_PALLAS", "full")
    return hits


def count_fused_forwards(monkeypatch) -> list:
    calls = []
    fwd = ups2x_fused._forward
    monkeypatch.setattr(ups2x_fused, "_forward",
                        lambda *a: calls.append(1) or fwd(*a))
    return calls


def test_sample_with_fused_route_matches_reference(fused_reference,
                                                   monkeypatch):
    jstate0 = reference_state(0)
    rng = np.random.RandomState(1)
    z = rng.randn(3, G_KW["z_dim"]).astype(np.float32)
    y = np.array([0, 4, 2], np.int32)
    # a jit of its own: the route is read when the function is traced
    ref = jax.jit(functools.partial(jstep.sample, g_cfg=JGConfig(**G_KW)))(
        jstate0["g_ema"], jstate0["g"]["stats"], jstate0["g"]["sn_u"],
        jnp.asarray(z), jnp.asarray(y))
    n_levels = GConfig(**G_KW).n_levels
    assert len(fused_reference) == n_levels

    state = interop.load_train_state(flat_np(jstate0))
    calls = count_fused_forwards(monkeypatch)
    args = (state["g_ema"], state["g"]["stats"], state["g"]["sn_u"],
            torch.from_numpy(z), torch.from_numpy(y).long())
    ours = step.sample(*args, GConfig(**G_KW, ups_fused="full"))
    assert len(calls) == n_levels
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    off = step.sample(*args, GConfig(**G_KW))
    assert len(calls) == n_levels
    np.testing.assert_allclose(ours.numpy(), off.numpy(), rtol=0, atol=1e-5)


def test_train_step_with_fused_route_matches_reference(fused_reference):
    jstate0 = reference_state(0)
    rng = np.random.RandomState(1)
    b = 2
    real = np.tanh(rng.randn(b, 4, 32, 32, 3)).astype(np.float32)
    y = np.array([1, 4], np.int32)
    key = jax.random.PRNGKey(2)
    f = jax.jit(functools.partial(
        jstep.train_step, g_cfg=JGConfig(**G_KW), ds_cfg=JDSConfig(**DS_KW),
        dt_cfg=JDTConfig(**DT_KW), tc=jstate.TrainConfig(**TC_KW)))
    jnew, jmetrics = f(jstate0, jnp.asarray(real), jnp.asarray(y), key)
    assert fused_reference, "the reference did not take its fused route"

    before = (kernels.ups2x_fused.ups2x.launches,
              kernels.ups2x_fused.ups2x_bwd.launches)
    new, metrics = step.train_step(
        interop.load_train_state(flat_np(jstate0)), torch.from_numpy(real),
        torch.from_numpy(y).long(),
        ReferenceDraws(key, b, G_KW["z_dim"], G_KW["n_frames"],
                       DS_KW["k_frames"]),
        GConfig(**G_KW, ups_fused="full"), DSConfig(**DS_KW),
        DTConfig(**DT_KW), train_state.TrainConfig(**TC_KW))
    assert (kernels.ups2x_fused.ups2x.launches,
            kernels.ups2x_fused.ups2x_bwd.launches) == before   # CPU tensors
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), atol=1e-4,
                                   err_msg=k)
    ref, ours = flat_np(jnew), interop.train_state_to_flat(new)
    assert ours.keys() == ref.keys()
    for m in ("g", "ds", "dt"):
        mu = {k: v for k, v in ref.items() if k.startswith(f"{m}/opt/0/mu/")}
        scale = max(np.abs(v).max() for v in mu.values())
        for k, want in mu.items():
            np.testing.assert_allclose(ours[k], want, rtol=0,
                                       atol=5e-6 * scale, err_msg=k)
    for k in ("g/stats/out_bn/mean", "g/stats/levels/0/bn1/var",
              "g/sn_u/levels/0/block/conv1/w"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_accum_remat_step_with_fused_route_equals_unfused(monkeypatch):
    """grad_accum=2 + remat: "full" gives the step "off" gives, and the
    fused forward runs once per level per G forward (the fake pass and the
    two micro forwards), never from the remat backward."""
    jstate0 = reference_state(0)
    state0 = interop.load_train_state(flat_np(jstate0))
    rng = np.random.RandomState(1)
    b = 4
    real = torch.from_numpy(np.tanh(rng.randn(b, 4, 32, 32, 3)).astype(
        np.float32))
    y = torch.tensor([1, 4, 0, 2])
    key = jax.random.PRNGKey(2)
    tc = train_state.TrainConfig(**TC_KW, grad_accum=2)

    def run(mode):
        draws = ReferenceDraws(key, b, G_KW["z_dim"], G_KW["n_frames"],
                               DS_KW["k_frames"])
        return step.train_step(
            state0, real, y, draws,
            GConfig(**G_KW, remat=True, ups_fused=mode), DSConfig(**DS_KW),
            DTConfig(**DT_KW), tc)

    off, off_m = run("off")
    calls = count_fused_forwards(monkeypatch)
    full, full_m = run("full")
    assert len(calls) == GConfig(**G_KW).n_levels * (1 + tc.grad_accum)
    for k in off_m:
        assert abs(float(full_m[k]) - float(off_m[k])) <= 1e-5, k
    for m in ("g", "ds", "dt"):
        ref_mu = tree.flatten_with_paths(off[m]["opt"]["mu"])
        mu = tree.flatten_with_paths(full[m]["opt"]["mu"])
        scale = max(float(v.abs().max()) for v in ref_mu.values())
        for k, want in ref_mu.items():
            assert float((mu[k] - want).abs().max()) <= 1e-5 * scale, (m, k)
    for k, want in tree.flatten_with_paths(off["g"]["stats"]).items():
        got = tree.flatten_with_paths(full["g"]["stats"])[k]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=k)


def test_remat_with_fused_route_equals_plain(monkeypatch):
    """G forward + backward with remat and the fused route: the loss, the
    gradients and the BN stats of the plain forward, and one fused forward
    per level."""
    cfg = GConfig(**G_KW, ups_fused="full")
    gen = torch.Generator().manual_seed(0)
    params, stats = generator.init(gen, cfg)
    params = tree.tree_map(
        lambda p: p + 0.05 * torch.randn(p.shape, generator=gen), params)
    z = torch.randn(2, cfg.z_dim, generator=gen)
    y = torch.tensor([1, 3])
    calls = count_fused_forwards(monkeypatch)

    def run(remat):
        leaves = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        flat = tree.flatten_with_paths(leaves)
        n0 = len(calls)
        video, new_stats = generator.apply(
            leaves, stats, z, y, GConfig(**G_KW, ups_fused="full",
                                         remat=remat), train=True)
        loss = (video ** 2).mean() + video.sum() * 1e-3
        grads = torch.autograd.grad(loss, list(flat.values()))
        return (loss.detach(), dict(zip(flat, grads)),
                tree.flatten_with_paths(new_stats), len(calls) - n0)

    plain, remat = run(False), run(True)
    assert plain[3] == remat[3] == cfg.n_levels
    assert torch.equal(plain[0], remat[0])
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k
        assert float(g.abs().max()) > 0, k
    for k, s in plain[2].items():
        assert torch.equal(s, remat[2][k]), k


def test_state_saved_under_off_samples_under_full(tmp_path):
    """The route adds no parameter: a train state written by an "off" run
    loads and samples under "full", to the clips "off" gives."""
    flags = ["--img_size", "32", "--n_frames", "4", "--ch", "8", "--d_ch",
             "8", "--n_classes", "5", "--emb_dim", "16", "--attn_res", "16",
             "--k_frames", "2", "--batch_size", "2", "--d_steps", "1",
             "--ema_start", "0", "--bf16", "0", "--device", "cpu"]
    state = cli.main(["--mode", "train", *flags, "--total_step", "1",
                      "--model_save_step", "1", "--out_dir",
                      str(tmp_path / "off")])
    full_state = train_state.create(0, GConfig(**G_KW, ups_fused="full"),
                                    DSConfig(**DS_KW), DTConfig(**DT_KW))
    assert (interop.train_state_to_flat(full_state).keys()
            == interop.train_state_to_flat(state).keys())
    weights = str(tmp_path / "off" / "checkpoints" / "1" / "train_state.npz")
    clips = {}
    for mode in ("off", "full"):
        clips[mode] = cli.main(["--mode", "sample", *flags, "--n_samples",
                                "2", "--weights", weights, "--ups_fused",
                                mode, "--out_dir", str(tmp_path / mode)])
    assert clips["full"].shape == (2, 4, 32, 32, 3)
    np.testing.assert_allclose(clips["full"], clips["off"], rtol=0,
                               atol=1e-5)


def test_train_cli_prints_fused_launch_counts(tmp_path, capsys):
    flags = ["--img_size", "32", "--n_frames", "4", "--ch", "8", "--d_ch",
             "8", "--n_classes", "5", "--emb_dim", "16", "--attn_res", "16",
             "--k_frames", "2", "--batch_size", "2", "--d_steps", "1",
             "--ema_start", "0", "--bf16", "0", "--device", "cpu",
             "--ups_fused", "full"]
    cli.main(["--mode", "train", *flags, "--total_step", "1", "--log_step",
              "1", "--out_dir", str(tmp_path)])
    _, fields = parse_step_line([ln for ln in capsys.readouterr().out
                                 .splitlines() if ln.startswith("step ")][0])
    # on the CPU the plain versions run: every launch count is 0
    assert [fields[f"{k}_launches"] for k in ("k1", "k2", "k3", "k5a",
                                              "k5b")] == [0] * 5
    assert np.isfinite(float(fields["g_loss"]))
