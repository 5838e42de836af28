"""`correct` is a comparison shown to fail. At the smoke preset on the CPU,
held to the flagship cells' own limits:

  * the control, the plain reference computed in the precision below the
    configuration's (fp8 e4m3 operands for bf16) in the program's place,
    is not correct;
  * a run whose timed path is broken underneath, with the harness's look
    for a card skipped, is not correct, for each fault the cell can have:
    training, a step that returns its state unchanged, one that leaves
    half of the batch out (the mean over the rest), D's Adam at G's
    learning rate, EMA steps ten times too large, G's gradient negated,
    and the blocked GRU sequence (K3's route) restarting every frame from
    h0; sampling, a clip altered where it is produced and half of the
    batch left out."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import common, compare, run, spec
from port_bench.tests.smoke import smoke_root

REAL = {"smoke.train": "ucf101_64.train", "smoke.sample": "ucf101_64.sample"}
SEED = 2 ** 31 + 23


def _ctx(root, cell):
    bench = spec.load(root)
    c = spec.cell(bench, cell)
    return common.Ctx(
        cell=cell, chips=1, config=spec.config(bench, root, c["config"]),
        mix=spec.traffic(bench, root, c["traffic"]),
        limits=spec.limits(bench, root, cell), seed=SEED, seconds=1.0,
        trace=False, device=torch.device("cpu"), tmp=root / "run",
        started=time.perf_counter())


def test_the_training_control_is_not_correct(tmp_path):
    root = smoke_root(tmp_path, REAL)
    ctx = _ctx(root, "smoke.train")
    entry = spec.entry(spec.load(root), root, "train")
    cell = entry.TrainCell(ctx)
    ref, made = cell.reference(SEED), cell.made()
    low = cell.reference(SEED, prec="fp8")
    d, k = cell.spec.d_steps, cell.k
    expected = {"g": k, "ds": k * d, "dt": k * d}
    control = compare.train_numbers(
        expected, {"count": expected, "end": low["end"],
                   "stats": low["stats"], "nu": low["nu"]}, ref, made)
    ok, checks = common.judge(control, ctx.limits)
    assert not ok, checks
    sound = cell.numbers(cell.call1(), ref)
    assert common.judge(sound, ctx.limits)[0], sound


def test_the_sampling_control_is_not_correct(tmp_path):
    root = smoke_root(tmp_path, REAL)
    ctx = _ctx(root, "smoke.sample")
    entry = spec.entry(spec.load(root), root, "sample")
    cell = entry.SampleCell(ctx)
    ref = cell.reference(SEED, [0, 1])
    low = cell.reference(SEED, [0, 1], prec="fp8")
    control = compare.clip_numbers([(low[i], ref[i]) for i in (0, 1)])
    ok, checks = common.judge(control, ctx.limits)
    assert not ok, checks


def _unchanged(orig):
    def step(state, *args, **kw):
        return state, orig(state, *args, **kw)[1]
    return step


class _Half:
    def __init__(self, draws, h):
        self.draws, self.h = draws, h

    def z(self, s):
        return self.draws.z(s)[:self.h]

    def idx(self, s):
        return self.draws.idx(s)[:self.h]


def _half_step(orig):
    def step(state, real, y, draws, *args, **kw):
        h = real.shape[0] // 2
        return orig(state, real[:h], y[:h], _Half(draws, h), *args, **kw)
    return step


def _d_at_g_rate(orig):
    def adam(grads, model, lr, tc):
        return orig(grads, model, tc.lr_g if lr == tc.lr_d else lr, tc)
    return adam


def _g_flipped(orig):
    from dvdgan_tpu_torch.core import tree as tru

    def adam(grads, model, lr, tc):
        if lr == tc.lr_g:
            grads = tru.tree_map(torch.neg, grads)
        return orig(grads, model, lr, tc)
    return adam


def _ema_tenfold(orig):
    def ema_update(ema, params, decay, step, start):
        return orig(ema, params, 1 - 10 * (1 - decay), step, start)
    return ema_update


class _no_carry:
    def __init__(self, orig):
        self.orig = orig

    @property
    def launches(self):
        return self.orig.launches

    def __call__(self, gx, cx, h0, wg, wc):
        return torch.cat([self.orig(gx[t:t + 1], cx[t:t + 1], h0, wg, wc)
                          for t in range(gx.shape[0])])


def _altered(orig):
    def sample(*args, **kw):
        out = orig(*args, **kw).clone()
        out[0] = -out[0]
        return out
    return sample


def _half_sample(orig):
    def sample(*args, **kw):
        out = orig(*args, **kw).clone()
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out
    return sample


def _module(name):
    from dvdgan_tpu_torch import kernels
    from dvdgan_tpu_torch.train import state, step
    return {"step": step, "state": state, "kernels": kernels}[name]


@pytest.mark.parametrize("cell, module, target, fault", [
    ("smoke.train", "step", "train_step", _unchanged),
    ("smoke.train", "step", "train_step", _half_step),
    ("smoke.train", "step", "_adam", _d_at_g_rate),
    ("smoke.train", "step", "_adam", _g_flipped),
    ("smoke.train", "state", "ema_update", _ema_tenfold),
    ("smoke.train", "kernels", "gru_sequence_blocked", _no_carry),
    ("smoke.sample", "step", "sample", _altered),
    ("smoke.sample", "step", "sample", _half_sample)])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            module, target, fault):
    from dvdgan_tpu_torch.ops import convgru
    root = smoke_root(tmp_path, REAL)
    mod = _module(module)
    monkeypatch.setattr(mod, target, fault(getattr(mod, target)))
    if target == "gru_sequence_blocked":     # the smoke's 32×32 GRU to K3
        monkeypatch.setattr(convgru, "uses_blocked",
                            lambda h, w: h * w >= 32 * 32)
    line = run.run_cell(root, cell, SEED, 1.0, False, device="cpu",
                        started=time.perf_counter())
    assert line["correct"] is False, line["checks"]
