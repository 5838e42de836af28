"""The remat policies (`--remat_save`, `GConfig.remat_save`), port vs
dvdgan_tpu's `_remat_save` (DVDGAN_REMAT_SAVE).

  * under each of none, gru, ups and gru+ups, with the upsample conv
    unfused and fused, G's loss, every gradient and the BN statistics
    equal those of the plain forward bitwise;
  * the sequence kernels' entry runs once per level in a forward and
    backward where the policy keeps the GRU's output (gru, gru+ups) and
    twice where it does not (none, ups: the region replays it); the
    unfused upsample conv (G's one 2×2-kernel conv) runs once per level
    where the policy keeps its output (ups, gru+ups) and twice elsewhere;
    the fused one (K5a's entry) once under gru+ups, where it runs between
    the regions, and twice under the others, where it runs inside one;
  * G under "none" against `jax.grad` of the reference's G with
    DVDGAN_REMAT_SAVE=none, from the same perturbed weights, at the limit
    of `test_torch_port_longclip.py`'s G gradients (5e-5 × max|grad|);
  * one train step with remat under each policy (and the fused upsample
    conv) calls the GRU kernels' entries and K5a's for as many time steps
    and convs as `chip_smoke.launches_per_step` expects on the card;
  * the flag reaches GConfig, and an unknown value raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.models import generator as jgen
from dvdgan_tpu_torch import kernels
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.kernels import convgru_bwd, convgru_seq, ups2x_fused
from dvdgan_tpu_torch.models import GConfig, generator
from dvdgan_tpu_torch.models.config import REMAT_SAVE_MODES
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.utils.config import build_parser, parse_config

from test_torch_port_attn_route import load_chip_smoke
from test_torch_port_longclip import G_KW, g_loss_and_grads, perturbed, tt

# (GRU entry calls, unfused upsample convs, fused upsample calls) per level
# in one forward + backward
RUNS = {"none": (2, 2, 2), "gru": (1, 2, 2), "ups": (2, 1, 2),
        "gru+ups": (1, 1, 1)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it
    (`test_torch_port_fp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g_inputs():
    cfg = GConfig(**G_KW)
    gen = torch.Generator().manual_seed(0)
    params, stats = generator.init(gen, cfg)
    params = tree.tree_map(
        lambda p: p + 0.05 * torch.randn(p.shape, generator=gen), params)
    z = torch.randn(2, cfg.z_dim, generator=gen)
    return params, stats, z, torch.tensor([1, 3])


@pytest.fixture(scope="module")
def plain_runs(g_inputs):
    """The plain forward + backward on each upsample route."""
    mp = pytest.MonkeyPatch()
    try:
        return {ups: g_loss_and_grads(GConfig(**G_KW, ups_fused=ups),
                                      *g_inputs, mp)
                for ups in ("off", "full")}
    finally:
        mp.undo()


@pytest.mark.parametrize("ups", ["off", "full"])
@pytest.mark.parametrize("save", REMAT_SAVE_MODES)
def test_policy_equals_plain_and_counts_its_reruns(save, ups, g_inputs,
                                                   plain_runs, monkeypatch):
    fused_calls = []
    forward = ups2x_fused._forward
    monkeypatch.setattr(ups2x_fused, "_forward",
                        lambda *a: fused_calls.append(1) or forward(*a))
    cfg = GConfig(**G_KW, ups_fused=ups, remat=True, remat_save=save)
    plain = plain_runs[ups]
    remat = g_loss_and_grads(cfg, *g_inputs, monkeypatch)
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys() and len(plain[1]) > 40
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k
    for k, s in plain[2].items():       # BN stats: the first forward's
        assert torch.equal(s, remat[2][k]), k
    n = cfg.n_levels
    gru_runs, conv_runs, fused_runs = RUNS[save]
    assert plain[3] == n and remat[3] == gru_runs * n
    if ups == "off":
        assert plain[4][(2, 2)] == n and remat[4][(2, 2)] == conv_runs * n
        assert not fused_calls
    else:
        assert (2, 2) not in remat[4] and len(fused_calls) == fused_runs * n


def test_none_matches_reference_grad(monkeypatch):
    """The port's G under remat_save "none" against jax.grad of the
    reference's G under DVDGAN_REMAT_SAVE=none (one jax.checkpoint a
    level), train mode, from the same perturbed weights."""
    monkeypatch.setenv("DVDGAN_REMAT_SAVE", "none")
    jparams, jstats = jgen.init(jax.random.PRNGKey(3), JGConfig(**G_KW))
    jparams = perturbed(jparams, 3)
    rng = np.random.RandomState(3)
    z = rng.randn(2, G_KW["z_dim"]).astype(np.float32)
    y = np.array([1, 3], np.int32)
    weights = np.linspace(-1.0, 1.0, 2 * 4 * 32 * 32 * 3,
                          dtype=np.float32).reshape(2, 4, 32, 32, 3)

    def loss_fn(p):
        video, new_stats = jgen.apply(p, jstats, jnp.asarray(z),
                                      jnp.asarray(y),
                                      JGConfig(**G_KW, remat=True),
                                      train=True)
        return (video * weights).sum() + (video ** 2).mean(), new_stats

    (jloss, jnew), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams)
    cfg = GConfig(**G_KW, remat=True, remat_save="none")
    loss, grads, new_stats, gru_calls, _ = g_loss_and_grads(
        cfg, tt(jparams), tt(jstats), torch.from_numpy(z),
        torch.from_numpy(y).long(), monkeypatch)
    assert gru_calls == 2 * cfg.n_levels
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = {k: np.asarray(v) for k, v in
           tree.flatten_with_paths(jax.device_get(jgrads)).items()}
    scale = max(np.abs(v).max() for v in ref.values())
    assert ref.keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k], atol=5e-5 * scale,
                                   rtol=0, err_msg=k)
    for k, s in tree.flatten_with_paths(jax.device_get(jnew)).items():
        np.testing.assert_allclose(new_stats[k].detach().numpy(),
                                   np.asarray(s), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("save", REMAT_SAVE_MODES)
def test_chip_smoke_counts_each_policys_launches(save, monkeypatch):
    """The time steps each GRU entry is called for, and K5a's calls, in
    one CPU train step with remat (grad_accum 2, the fused upsample conv;
    the plain versions run), times each kernel's launches, are what
    `launches_per_step` expects on the card."""
    cfg = parse_config(["--img_size", "32", "--n_frames", "4", "--ch", "8",
                        "--d_ch", "8", "--n_classes", "5", "--emb_dim", "16",
                        "--attn_res", "16", "--k_frames", "2",
                        "--batch_size", "2", "--grad_accum", "2",
                        "--d_steps", "1", "--bf16", "0", "--remat", "1",
                        "--ups_fused", "fwd", "--remat_save", save])
    g_cfg, ds_cfg, dt_cfg, tc = (cfg.g_config(), cfg.ds_config(),
                                 cfg.dt_config(), cfg.train_config())
    fwd, bwd, ups = [], [], []
    entry, back = kernels.gru_sequence_fused, convgru_bwd.gru_sequence_bwd
    forward = ups2x_fused._forward
    monkeypatch.setattr(kernels, "gru_sequence_fused",
                        lambda *a: fwd.append(a[0].shape[0]) or entry(*a))
    monkeypatch.setattr(convgru_bwd, "gru_sequence_bwd",
                        lambda *a: bwd.append(a[0].shape[0]) or back(*a))
    monkeypatch.setattr(ups2x_fused, "_forward",
                        lambda *a: ups.append(1) or forward(*a))
    draws = step.TorchDraws(3, 11, 2, g_cfg.z_dim, g_cfg.n_frames,
                            ds_cfg.k_frames, torch.float32, "cpu")
    step.train_step(train_state.create(0, g_cfg, ds_cfg, dt_cfg),
                    torch.zeros(2, cfg.n_frames, 32, 32, 3),
                    torch.zeros(2, dtype=torch.long), draws, g_cfg, ds_cfg,
                    dt_cfg, tc)
    want = load_chip_smoke().launches_per_step(cfg)
    assert sum(fwd) * convgru_seq.LAUNCHES_PER_STEP == want["k1_launches"]
    assert sum(bwd) * convgru_bwd.LAUNCHES_PER_STEP == want["k2_launches"]
    assert len(ups) * ups2x_fused.LAUNCHES_PER_CALL == want["k5a_launches"]


def test_flag_reaches_gconfig_and_unknown_values_raise():
    assert parse_config([]).g_config().remat_save == "gru+ups"
    for mode in REMAT_SAVE_MODES:
        cfg = parse_config(["--preset", "kinetics_256_48f", "--remat_save",
                            mode])
        assert cfg.g_config().remat_save == mode and cfg.g_config().remat
    with pytest.raises(ValueError, match="remat_save"):
        GConfig(**G_KW, remat_save="all")
    with pytest.raises(ValueError, match="remat_save"):
        dataclasses.replace(parse_config([]), remat_save="gru,ups").g_config()
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--remat_save", "all"])
