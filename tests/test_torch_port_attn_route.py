"""The fused spatial-attention route (`attn_fused="on"`, K6a/K6b) through
`ops/attention.py`, G and the train step, port vs dvdgan_tpu, on the CPU.

  * `separable_attn(p, x, fused="on")` vs the reference's `separable_attn`
    on its Pallas route, with `kernels.spatial_attn_fused` /
    `attention_spatial.spatial_attn_tiled` patched to their interpreted
    forms at run time (as `tests/test_kernels.py` does), both layouts, both
    entries: f32 atol 1e-5, and equal to `fused="off"`;
  * the slice as a whole at the repo's test scale (img 32, T 4, ch 8, f32):
    `sample` and one `train_step` with `attn_fused="on"` vs the JAX ones
    with G's attention on the interpreted Pallas route, at the tolerances of
    `test_torch_port_sample.py` (atol 1e-4) and `test_torch_port_train.py`
    (losses 1e-4, Adam mu 5e-6 × max|mu|), and vs the port's own "off";
  * with remat: loss, gradients and BN stats equal the no-remat ones, and
    the fused entry is entered once per G forward (none from the backward);
    one grad_accum=2 + remat step with "on" equals the step with "off";
  * the launches per step that `chip_smoke.py` expects of the four driven
    paths; a state saved under "off" samples under "on"; the CLI carries
    the flag and prints the K6 launch counts.
"""

from __future__ import annotations

import functools
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import attention_spatial as jka
from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.ops import attention as jattn
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu_torch import cli, interop, kernels
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.kernels import attention_spatial
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig, generator
from dvdgan_tpu_torch.ops import attention
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.utils.config import parse_config
from dvdgan_tpu_torch.utils.logging import parse_step_line

from test_torch_port_longclip import (ReferenceDraws, flat_np,
                                      reference_state, tt)

G_KW = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16)
DS_KW = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
DT_KW = dict(img_size=32, n_frames=4, ch=8, n_classes=5)
TC_KW = dict(d_steps=2, ema_start=0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it:
    the suite runs six workers on the machine's cores, where torch's default
    of a thread a core oversubscribes them (`test_torch_port_fp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def interpreted(monkeypatch) -> dict:
    """Patches the reference's two Pallas entries to their interpreted
    forms; returns the hits of each."""
    hits = {"fused": 0, "tiled": 0}
    fused, tiled = jka.spatial_attn_fused, jka.spatial_attn_tiled

    def fused_i(x, wq, wk, wv, wo, gamma, interpret=False):
        hits["fused"] += 1
        return fused(x, wq, wk, wv, wo, gamma, True)

    def tiled_i(x, wq, wk, wv, wo, gamma, interpret=False, force_bqr=None):
        hits["tiled"] += 1
        return tiled(x, wq, wk, wv, wo, gamma, True, force_bqr)

    monkeypatch.setattr(jattn.kernels, "spatial_attn_fused", fused_i)
    monkeypatch.setattr(jattn.kernels.attention_spatial, "spatial_attn_tiled",
                        tiled_i)
    return hits


@pytest.fixture
def fused_reference(monkeypatch):
    """The reference with G's attention on its Pallas route (G never passes
    `use_pallas`, and the auto gate is off on the CPU): `separable_attn`
    gets `use_pallas=True`, the kernel entry its interpreted form."""
    hits = interpreted(monkeypatch)
    monkeypatch.setattr(jattn, "separable_attn", functools.partial(
        jattn.separable_attn, use_pallas=True))
    return hits


def count_fused_forwards(monkeypatch) -> list:
    """The entry each call of the port's kernel wrapper was made through."""
    calls = []
    fwd = attention_spatial._forward
    monkeypatch.setattr(
        attention_spatial, "_forward",
        lambda entry, *a: calls.append(entry.__name__) or fwd(entry, *a))
    return calls


# --------------------------------------------------------------- the op ----

@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("entry", ["fused", "tiled"])
def test_separable_attn_on_matches_reference_pallas_route(monkeypatch, entry,
                                                          time_major):
    c = 16
    p = jattn.separable_attn_init(jax.random.PRNGKey(5), c)
    p = {k: dict(v, gamma=jnp.float32(g)) for (k, v), g in
         zip(p.items(), (0.7, -0.4))}                 # γ = 0 hides the branch
    shape = (3, 2, 8, 8, c) if time_major else (2, 3, 8, 8, c)
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    hits = interpreted(monkeypatch)
    if entry == "tiled":
        # the reference takes its tiled entry only through the auto gate,
        # where the un-tiled form does not fit
        monkeypatch.setenv("DVDGAN_ATTN_PALLAS", "on")
        monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
        monkeypatch.setattr(jka, "fits_vmem", lambda *a, **k: False)
        monkeypatch.setattr(attention, "TILED_MIN_PIXELS", 8 * 8)
        ref = jattn.separable_attn(p, jnp.asarray(x), time_major=time_major)
    else:
        ref = jattn.separable_attn(p, jnp.asarray(x), use_pallas=True,
                                   time_major=time_major)
    assert hits == {"fused": entry == "fused", "tiled": entry == "tiled"}

    calls = count_fused_forwards(monkeypatch)
    ours = attention.separable_attn(tt(p), torch.from_numpy(x), "on",
                                    time_major=time_major)
    assert calls == [f"spatial_attn_{entry}"]
    assert not np.allclose(np.asarray(ref), x, atol=1e-3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    off = attention.separable_attn(tt(p), torch.from_numpy(x),
                                   time_major=time_major)
    assert len(calls) == 1
    np.testing.assert_allclose(ours.numpy(), off.numpy(), atol=1e-5)


def test_uses_tiled_draws_the_line_at_64_squared():
    assert [attention.uses_tiled(r, r) for r in (16, 32, 64, 128)] == [
        False, False, True, True]
    assert attention.uses_tiled(32, 128) and not attention.uses_tiled(32, 64)


def test_separable_attn_refuses_odd_maps_and_unknown_routes():
    p = tt(jattn.separable_attn_init(jax.random.PRNGKey(7), 16))
    x = torch.randn(1, 2, 5, 6, 16, generator=torch.Generator().manual_seed(0))
    assert attention.separable_attn(p, x).shape == x.shape   # "off" takes it
    with pytest.raises(ValueError, match="even H and W"):
        attention.separable_attn(p, x, "on")
    with pytest.raises(ValueError, match="fused must be one of"):
        attention.separable_attn(p, x, "full")


def test_attn_fused_flag_reaches_gconfig():
    """--attn_fused is carried by Config and GConfig (no environment
    variable); its default is the unfused route."""
    assert parse_config([]).g_config().attn_fused == "off"
    for mode in ("off", "on"):
        cfg = parse_config(["--preset", "kinetics_128", "--attn_res", "64",
                            "--attn_fused", mode])
        assert cfg.attn_fused == cfg.g_config().attn_fused == mode
        assert cfg.g_config().attn_res == 64
    with pytest.raises(SystemExit):
        parse_config(["--attn_fused", "full"])


# ------------------------------------------------- the slice as a whole ----

def test_sample_with_fused_route_matches_reference(fused_reference,
                                                   monkeypatch):
    jstate0 = reference_state(0)
    rng = np.random.RandomState(1)
    z = rng.randn(3, G_KW["z_dim"]).astype(np.float32)
    y = np.array([0, 4, 2], np.int32)
    ref = jax.jit(functools.partial(jstep.sample, g_cfg=JGConfig(**G_KW)))(
        jstate0["g_ema"], jstate0["g"]["stats"], jstate0["g"]["sn_u"],
        jnp.asarray(z), jnp.asarray(y))
    assert fused_reference["fused"] == 1

    state = interop.load_train_state(flat_np(jstate0))
    calls = count_fused_forwards(monkeypatch)
    args = (state["g_ema"], state["g"]["stats"], state["g"]["sn_u"],
            torch.from_numpy(z), torch.from_numpy(y).long())
    ours = step.sample(*args, GConfig(**G_KW, attn_fused="on"))
    assert calls == ["spatial_attn_fused"]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    off = step.sample(*args, GConfig(**G_KW))
    assert len(calls) == 1
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
    assert fused_reference["fused"] > 0, "the reference took its XLA route"

    before = (kernels.spatial_attn_fused.launches,
              kernels.spatial_attn_tiled.launches)
    new, metrics = step.train_step(
        interop.load_train_state(flat_np(jstate0)), torch.from_numpy(real),
        torch.from_numpy(y).long(),
        ReferenceDraws(key, b, G_KW["z_dim"], G_KW["n_frames"],
                       DS_KW["k_frames"]),
        GConfig(**G_KW, attn_fused="on"), DSConfig(**DS_KW),
        DTConfig(**DT_KW), train_state.TrainConfig(**TC_KW))
    assert (kernels.spatial_attn_fused.launches,
            kernels.spatial_attn_tiled.launches) == before      # CPU tensors
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
              "g/sn_u/attn/spatial/theta/w", "g/params/attn/spatial/gamma"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("remat,grad_accum", [(False, 1), (True, 2)])
def test_train_step_with_fused_route_equals_unfused(monkeypatch, remat,
                                                    grad_accum):
    """"on" gives the step "off" gives, and the fused entry runs once per G
    forward (the fake pass and each micro forward), never from a backward,
    remat or not."""
    state0 = interop.load_train_state(flat_np(reference_state(0)))
    rng = np.random.RandomState(1)
    b = 4
    real = torch.from_numpy(np.tanh(rng.randn(b, 4, 32, 32, 3)).astype(
        np.float32))
    y = torch.tensor([1, 4, 0, 2])
    key = jax.random.PRNGKey(2)
    tc = train_state.TrainConfig(**TC_KW, grad_accum=grad_accum)

    def run(mode):
        draws = ReferenceDraws(key, b, G_KW["z_dim"], G_KW["n_frames"],
                               DS_KW["k_frames"])
        return step.train_step(
            state0, real, y, draws,
            GConfig(**G_KW, remat=remat, attn_fused=mode), DSConfig(**DS_KW),
            DTConfig(**DT_KW), tc)

    off, off_m = run("off")
    calls = count_fused_forwards(monkeypatch)
    on, on_m = run("on")
    assert calls == ["spatial_attn_fused"] * (1 + grad_accum)
    for k in off_m:
        assert abs(float(on_m[k]) - float(off_m[k])) <= 1e-5, k
    for m in ("g", "ds", "dt"):
        ref_mu = tree.flatten_with_paths(off[m]["opt"]["mu"])
        mu = tree.flatten_with_paths(on[m]["opt"]["mu"])
        scale = max(float(v.abs().max()) for v in ref_mu.values())
        for k, want in ref_mu.items():
            assert float((mu[k] - want).abs().max()) <= 1e-5 * scale, (m, k)
    for k, want in tree.flatten_with_paths(off["g"]["stats"]).items():
        got = tree.flatten_with_paths(on["g"]["stats"])[k]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=k)


@pytest.mark.parametrize("entry", ["fused", "tiled"])
def test_remat_with_fused_route_equals_plain(monkeypatch, entry):
    """G forward + backward with remat and the fused route: the loss, the
    gradients and the BN stats of the plain forward, and ONE call of the
    kernel wrapper per forward + backward (the spatial pass leaves the
    tail's checkpoint region; the temporal pass is a region of its own)."""
    if entry == "tiled":
        monkeypatch.setattr(attention, "TILED_MIN_PIXELS", 16 * 16)
    cfg = GConfig(**G_KW, attn_fused="on")
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
            leaves, stats, z, y, GConfig(**G_KW, attn_fused="on",
                                         remat=remat), train=True)
        loss = (video ** 2).mean() + video.sum() * 1e-3
        grads = torch.autograd.grad(loss, list(flat.values()))
        return (loss.detach(), dict(zip(flat, grads)),
                tree.flatten_with_paths(new_stats), calls[n0:])

    plain, remat = run(False), run(True)
    assert plain[3] == remat[3] == [f"spatial_attn_{entry}"]
    assert torch.equal(plain[0], remat[0])
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k
        assert float(g.abs().max()) > 0, k
    for k, s in plain[2].items():
        assert torch.equal(s, remat[2][k]), k


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("argv,k6a,k6b", [
    (["--preset", "ucf101_64", "--batch_size", "8"], 4, 0),
    (["--preset", "kinetics_256_48f", "--batch_size", "4", "--grad_accum",
      "2"], 6, 0),
    (["--preset", "kinetics_128", "--batch_size", "8", "--attn_res", "64",
      "--remat", "1"], 0, 4),
], ids=["flagship", "longclip", "128px_attn64"])
def test_chip_smoke_expects_the_k6_launches_of_each_path(argv, k6a, k6b):
    """Two launches per call, one call per G forward (the fake pass and one
    per micro-batch), through the entry the map's size picks; none with
    the route off."""
    smoke = load_chip_smoke()
    want = smoke.launches_per_step(parse_config(argv + ["--attn_fused", "on"]))
    assert (want["k6a_launches"], want["k6b_launches"]) == (k6a, k6b)
    off = smoke.launches_per_step(parse_config(argv))
    assert (off["k6a_launches"], off["k6b_launches"]) == (0, 0)
    assert {k: v for k, v in off.items() if "k6" not in k} == {
        k: v for k, v in want.items() if "k6" not in k}


FLAGS = ["--img_size", "32", "--n_frames", "4", "--ch", "8", "--d_ch", "8",
         "--n_classes", "5", "--emb_dim", "16", "--attn_res", "16",
         "--k_frames", "2", "--batch_size", "2", "--d_steps", "1",
         "--ema_start", "0", "--bf16", "0", "--device", "cpu"]


def test_state_saved_under_off_samples_under_on(tmp_path):
    """The route adds no parameter: a train state written by an "off" run
    loads and samples under "on", to the clips "off" gives."""
    state = cli.main(["--mode", "train", *FLAGS, "--total_step", "1",
                      "--model_save_step", "1", "--out_dir",
                      str(tmp_path / "off")])
    on_state = train_state.create(0, GConfig(**G_KW, attn_fused="on"),
                                  DSConfig(**DS_KW), DTConfig(**DT_KW))
    assert (interop.train_state_to_flat(on_state).keys()
            == interop.train_state_to_flat(state).keys())
    weights = str(tmp_path / "off" / "checkpoints" / "1" / "train_state.npz")
    clips = {}
    for mode in ("off", "on"):
        clips[mode] = cli.main(["--mode", "sample", *FLAGS, "--n_samples",
                                "2", "--weights", weights, "--attn_fused",
                                mode, "--out_dir", str(tmp_path / mode)])
    assert clips["on"].shape == (2, 4, 32, 32, 3)
    np.testing.assert_allclose(clips["on"], clips["off"], rtol=0, atol=1e-5)


def test_train_cli_prints_k6_launch_counts(tmp_path, capsys):
    cli.main(["--mode", "train", *FLAGS, "--attn_fused", "on", "--remat", "1",
              "--total_step", "1", "--log_step", "1", "--out_dir",
              str(tmp_path)])
    _, fields = parse_step_line([ln for ln in capsys.readouterr().out
                                 .splitlines() if ln.startswith("step ")][0])
    # on the CPU the plain versions run: every launch count is 0
    assert [fields[f"{k}_launches"] for k in (
        "k1", "k2", "k3", "k5a", "k5b", "k6a", "k6b")] == [0] * 7
    assert np.isfinite(float(fields["g_loss"]))
