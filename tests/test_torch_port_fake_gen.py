"""The train step's `fake_gen="per_step"` (the reference's
`dvdgan_tpu/train/step.py:239-245`), port vs dvdgan_tpu, at the repo's test
scale (img 32, T 4, ch 8, batch 2, f32): d_steps G forwards at batch B,
each with its own BN batch statistics, instead of one at d_steps·B.

  * one `per_step` step (d_steps 2, synthesis) against the reference's,
    through the draw hook, at `test_torch_port_fp.py`'s judges (the
    reference for every leaf but G's params, Adam state and EMA, which the
    port's float64 step judges; G's gradient within 5e-4 × max|mu| of the
    reference's);
  * `per_step` runs d_steps forwards at batch B where `pooled` runs one at
    d_steps·B, and its fakes differ;
  * the draws keep `draw_order` under `per_step` (so `HeldDraws` and
    `MultiStep` stay valid), with and without an FP prefix;
  * `chip_smoke.launches_per_step` counts the GRU kernels' launches the
    step's entries make (`per_step`'s forwards, FP's warm-ups), as the CPU
    step calls them;
  * an unknown `fake_gen` raises, as the reference does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dvdgan_tpu_torch import kernels
from dvdgan_tpu_torch.kernels import convgru_bwd, convgru_seq
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from test_torch_port_fp import (LOSSES, assert_g_close,  # noqa: F401
                                one_torch_thread, port_step_f64,
                                reference_and_port_step)
from test_torch_port_fp import DS_KW as FP_DS, DT_KW as FP_DT, G_KW as FP_G
from dvdgan_tpu_torch.utils.config import parse_config
from test_torch_port_attn_route import load_chip_smoke
from test_torch_port_steps_per_call import SpyDraws

G_KW = dict(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
            emb_dim=16, attn_res=16)
DS_KW = dict(img_size=32, ch=8, n_classes=5, k_frames=2)
DT_KW = dict(img_size=32, n_frames=4, ch=8, n_classes=5)
TC_KW = dict(d_steps=2, ema_start=0, fake_gen="per_step")
B = 2


def batch(seed: int, t: int = 4):
    rng = np.random.RandomState(seed)
    real = np.tanh(rng.randn(B, t, 32, 32, 3)).astype(np.float32)
    return real, np.array([1, 4], np.int32)


def test_per_step_train_step_matches_reference():
    real, y = batch(1)
    kws = dict(g_kw=G_KW, ds_kw=DS_KW, dt_kw=DT_KW, tc_kw=TC_KW)
    old, ref, jmetrics, new, metrics = reference_and_port_step(
        0, real, y, key_seed=2, **kws)
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=1e-4, err_msg=k)
        assert float(metrics[k]) > 0, k
    assert_g_close(old, ref, new, port_step_f64(old, real, y, 2, **kws))


def configs(fp: bool, fake_gen: str, d_steps: int = 2):
    g, ds, dt = (FP_G, FP_DS, FP_DT) if fp else (G_KW, DS_KW, DT_KW)
    return (GConfig(**g), DSConfig(**ds), DTConfig(**dt),
            train_state.TrainConfig(d_steps=d_steps, ema_start=0,
                                    fake_gen=fake_gen))


def draws(g_cfg, ds_cfg, seed: int = 11):
    return step.TorchDraws(3, seed, B, g_cfg.z_dim, g_cfg.n_frames,
                           ds_cfg.k_frames, torch.float32, "cpu")


def test_per_step_runs_one_forward_per_d_step(monkeypatch):
    """No-grad G forwards (the D phase's fakes): batches, and the fakes
    each mode hands to the D steps."""
    g_cfg, ds_cfg, dt_cfg, _ = configs(False, "pooled")
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    real, y = batch(2)
    real, y = torch.from_numpy(real), torch.from_numpy(y).long()
    apply = step.generator.apply
    seen = {}

    def spy(params, stats, z, *a, **kw):
        out = apply(params, stats, z, *a, **kw)
        if not torch.is_grad_enabled():
            seen.setdefault(mode, []).append((z.shape[0], out[0]))
        return out

    monkeypatch.setattr(step.generator, "apply", spy)
    for mode in ("pooled", "per_step"):
        step.train_step(state, real, y, draws(g_cfg, ds_cfg), *configs(
            False, mode))
    assert [n for n, _ in seen["pooled"]] == [2 * B]
    assert [n for n, _ in seen["per_step"]] == [B, B]
    pooled = seen["pooled"][0][1]
    per_step = torch.cat([v for _, v in seen["per_step"]])
    # the same z and y, other BN batch statistics: other fakes
    assert pooled.shape == per_step.shape
    assert not torch.allclose(pooled, per_step, atol=1e-3)


@pytest.mark.parametrize("fp", [False, True], ids=["synthesis", "fp"])
def test_per_step_keeps_the_draw_order(fp):
    g_cfg, ds_cfg, dt_cfg, tc = configs(fp, "per_step")
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    spy = SpyDraws(draws(g_cfg, ds_cfg))
    real = torch.zeros(B, g_cfg.cond_frames + g_cfg.n_frames, 32, 32, 3)
    step.train_step(state, real, torch.zeros(B, dtype=torch.long), spy,
                    g_cfg, ds_cfg, dt_cfg, tc)
    assert [c[:2] for c in spy.calls] == step.draw_order(tc.d_steps)
    held = step.HeldDraws(tc.d_steps, B, g_cfg.z_dim, ds_cfg.k_frames,
                          torch.float32, torch.device("cpu"))
    held.fill(draws(g_cfg, ds_cfg))
    for kind, stream, v in spy.calls:
        assert torch.equal(getattr(held, kind)(stream), v), (kind, stream)


def test_an_unknown_fake_gen_raises():
    g_cfg, ds_cfg, dt_cfg, tc = configs(False, "per_batch")
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    real, y = batch(0)
    with pytest.raises(ValueError, match="fake_gen must be one of"):
        step.train_step(state, torch.from_numpy(real),
                        torch.from_numpy(y).long(), None, g_cfg, ds_cfg,
                        dt_cfg, tc)


@pytest.mark.parametrize("flags", [
    ["--fake_gen", "per_step"],
    ["--n_frames", "6", "--cond_frames", "2"],
    ["--n_frames", "6", "--cond_frames", "2", "--fake_gen", "per_step"],
], ids=["per_step", "fp", "fp_per_step"])
def test_chip_smoke_counts_the_steps_gru_launches(flags, monkeypatch):
    """The time steps each GRU entry is called for in one CPU step (where
    the plain versions run), times the kernels' launches a time step, are
    the K1 and K2 launches `launches_per_step` expects on the card."""
    cfg = parse_config(["--img_size", "32", "--n_frames", "4", "--ch", "8",
                        "--d_ch", "8", "--n_classes", "5", "--emb_dim", "16",
                        "--attn_res", "16", "--k_frames", "2",
                        "--batch_size", "2", "--bf16", "0", *flags])
    g_cfg, ds_cfg, dt_cfg, tc = (cfg.g_config(), cfg.ds_config(),
                                 cfg.dt_config(), cfg.train_config())
    fwd, bwd = [], []
    entry, back = kernels.gru_sequence_fused, convgru_bwd.gru_sequence_bwd
    monkeypatch.setattr(kernels, "gru_sequence_fused",
                        lambda *a: fwd.append(a[0].shape[0]) or entry(*a))
    monkeypatch.setattr(convgru_bwd, "gru_sequence_bwd",
                        lambda *a: bwd.append(a[0].shape[0]) or back(*a))
    real = torch.zeros(2, cfg.n_frames, 32, 32, 3)
    step.train_step(train_state.create(0, g_cfg, ds_cfg, dt_cfg), real,
                    torch.zeros(2, dtype=torch.long), draws(g_cfg, ds_cfg),
                    g_cfg, ds_cfg, dt_cfg, tc)
    want = load_chip_smoke().launches_per_step(cfg)
    assert sum(fwd) * convgru_seq.LAUNCHES_PER_STEP == want["k1_launches"]
    assert sum(bwd) * convgru_bwd.LAUNCHES_PER_STEP == want["k2_launches"]
