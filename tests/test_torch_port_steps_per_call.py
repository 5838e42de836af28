"""`--steps_per_call K` in the port (`train.step.MultiStep`, the trainer's
K path), on the CPU at the repo's test scale (img 32, T 4, ch 8, batch 2,
f32), where the K-step object runs its K steps eagerly on its own buffers
(static batches, draws made ahead of the steps, the state copied back):
the K = 2 trainer gives the K = 1 trainer's final state bitwise and the
same metrics at the log steps, also when resumed at step 2; `MultiStep`
gives K `train_step` calls' bits; the pre-made draws follow `train_step`'s
own calls, recorded through a spying draws object; the schedule rule is
the reference's (`dvdgan_tpu/train/trainer.py:_effective_steps_per_call`);
`--nan_check`, the loop's device reads and the profile window under K.
TensorBoard is off in these trainers (its import takes seconds).
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from dvdgan_tpu.train import trainer as jtrainer
from dvdgan_tpu.utils import config as jconfig
from dvdgan_tpu_torch import interop
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step as step_mod
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging
from dvdgan_tpu_torch.utils.config import Config

KW = dict(dataset="synthetic", n_classes=5, img_size=32, n_frames=4, ch=8,
          d_ch=8, emb_dim=16, attn_res=16, k_frames=2, batch_size=2,
          d_steps=1, bf16=False, ema_start=0, seed=5, device="cpu",
          log_step=2, sample_step=0, model_save_step=0, total_step=4)
LOSSES = ("d_loss", "d_loss_s", "d_loss_t", "g_loss")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after it:
    the suite runs six workers on the machine's cores, where torch's default
    of a thread a core oversubscribes them (`test_torch_port_fp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(trainer_mod, "MetricWriter", functools.partial(
        plogging.MetricWriter, use_tensorboard=False))


def make_trainer(out_dir, **kw) -> trainer_mod.Trainer:
    return trainer_mod.Trainer(Config(**{**KW, "out_dir": str(out_dir), **kw}))


def run(out_dir, **kw) -> tuple[dict, dict]:
    """(final flat state, {step: {loss: value}} from scalars.jsonl)."""
    tr = make_trainer(out_dir, **kw)
    tr.train()
    tr.close()
    scalars: dict = {}
    with open(out_dir / "logs" / "scalars.jsonl") as f:
        for ln in f:
            r = json.loads(ln)
            if r["tag"] in LOSSES:
                scalars.setdefault(r["step"], {})[r["tag"]] = r["value"]
    return interop.train_state_to_flat(tr.state), scalars


@pytest.fixture(scope="module")
def single_steps(tmp_path_factory):
    """The K = 1 trainer's 4 steps: final state and logged metrics."""
    return run(tmp_path_factory.mktemp("k1"))


@pytest.mark.parametrize("resume", [False, True],
                         ids=["uninterrupted", "resumed_at_2"])
def test_k2_trainer_gives_the_single_step_bits(single_steps, resume,
                                               tmp_path):
    want_state, want_scalars = single_steps
    if resume:
        run(tmp_path, steps_per_call=2, total_step=2, model_save_step=2)
    state, scalars = run(tmp_path, steps_per_call=2, model_save_step=2)
    assert state.keys() == want_state.keys()
    differ = [k for k, v in want_state.items()
              if not np.array_equal(v, state[k])]
    assert not differ, differ
    assert int(state["step"]) == 4
    # the log steps' metrics (the reference reports a call's last step)
    steps = [4] if resume else [2, 4]
    assert {s: scalars[s] for s in steps} == {s: want_scalars[s]
                                              for s in steps}


@pytest.mark.parametrize("k", [2, 3])
def test_multi_step_gives_k_train_steps(k):
    cfg = Config(**KW)
    g_cfg, ds_cfg, dt_cfg, tc = (cfg.g_config(), cfg.ds_config(),
                                 cfg.dt_config(), cfg.train_config())
    state = train_state.create(1, g_cfg, ds_cfg, dt_cfg)
    rng = np.random.RandomState(0)
    reals = torch.from_numpy(np.tanh(rng.randn(k, 2, 4, 32, 32, 3))
                             .astype(np.float32))
    ys = torch.from_numpy(rng.randint(0, 5, (k, 2)))
    start = 6
    want, want_m = state, []
    for j in range(k):
        draws = step_mod.TorchDraws(9, start + j, 2, g_cfg.z_dim,
                                    g_cfg.n_frames, ds_cfg.k_frames,
                                    torch.float32, "cpu")
        want, m = step_mod.train_step(want, reals[j], ys[j], draws, g_cfg,
                                      ds_cfg, dt_cfg, tc)
        want_m.append(m)
    multi = step_mod.MultiStep(state, k, 2, g_cfg, ds_cfg, dt_cfg, tc, 9,
                               torch.float32, "cpu",
                               trainer_mod.launch_counts)
    before = interop.train_state_to_flat(state)
    got, metrics = multi(state, reals, ys, start)
    assert got is multi.state
    # the caller's state is copied in, never written
    after = interop.train_state_to_flat(state)
    assert all(np.array_equal(v, after[p]) for p, v in before.items())
    flat_got, flat_want = (interop.train_state_to_flat(s)
                           for s in (got, want))
    assert all(np.array_equal(v, flat_got[p]) for p, v in flat_want.items())
    assert set(metrics) == set(want_m[0])
    for name, v in metrics.items():
        assert v.shape == (k,)
        assert torch.equal(v, torch.stack([m[name] for m in want_m]))
    # the plain versions run on the CPU: no kernel launches
    assert set(multi.launches.values()) == {0}
    # the next call goes on from the buffers it returned
    again, _ = multi(got, reals, ys, start + k)
    assert again is multi.state and int(again["step"]) == 2 * k


class SpyDraws:
    """Records the calls `train_step` makes and their values."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def z(self, stream):
        v = self.inner.z(stream)
        self.calls.append(("z", stream, v))
        return v

    def idx(self, stream):
        v = self.inner.idx(stream)
        self.calls.append(("idx", stream, v))
        return v


@pytest.mark.parametrize("d_steps", [1, 2])
def test_held_draws_follow_train_steps_own_calls(d_steps):
    cfg = Config(**{**KW, "d_steps": d_steps})
    g_cfg, ds_cfg = cfg.g_config(), cfg.ds_config()
    state = train_state.create(0, g_cfg, ds_cfg, cfg.dt_config())

    def draws():
        return step_mod.TorchDraws(3, 11, 2, g_cfg.z_dim, g_cfg.n_frames,
                                   ds_cfg.k_frames, torch.float32, "cpu")

    spy = SpyDraws(draws())
    real = torch.zeros(2, 4, 32, 32, 3)
    step_mod.train_step(state, real, torch.zeros(2, dtype=torch.long), spy,
                        g_cfg, ds_cfg, cfg.dt_config(), cfg.train_config())
    assert [c[:2] for c in spy.calls] == step_mod.draw_order(d_steps)
    held = step_mod.HeldDraws(d_steps, 2, g_cfg.z_dim, ds_cfg.k_frames,
                              torch.float32, torch.device("cpu"))
    held.fill(draws())
    for kind, stream, v in spy.calls:
        assert torch.equal(getattr(held, kind)(stream), v), (kind, stream)


@pytest.mark.parametrize("change,want", [
    (dict(log_step=3), 1),                  # the reference's own case
    (dict(sample_step=5), 1),
    (dict(model_save_step=3), 1),
    (dict(total_step=6, log_step=2), 2),
], ids=["log_step", "sample_step", "model_save_step", "aligned"])
def test_schedule_rule_is_the_reference(change, want, capsys):
    kw = {**KW, "steps_per_call": 2, **change}
    got = trainer_mod.effective_steps_per_call(Config(**kw), 0)
    ours = capsys.readouterr().out
    # the reference's rule on the same config
    ref = jtrainer.Trainer.__new__(jtrainer.Trainer)
    ref.cfg = jconfig.Config(**{k: v for k, v in kw.items()
                                if k != "device"})
    ref.start_step = 0
    assert got == want == ref._effective_steps_per_call()
    assert ours == capsys.readouterr().out
    if want == 1:
        assert "falling back to per-step dispatch" in ours


def test_schedule_rule_checks_the_resume_step(tmp_path):
    run(tmp_path, total_step=1, model_save_step=1)
    tr = make_trainer(tmp_path, steps_per_call=2, model_save_step=2)
    assert tr.start_step == 1 and tr.steps_per_call == 1
    tr.close()


def test_total_step_override_off_the_call_boundary_raises(tmp_path):
    tr = make_trainer(tmp_path, steps_per_call=2)
    assert tr.steps_per_call == 2
    with pytest.raises(ValueError, match="not a multiple of steps_per_call"):
        tr.train(total_step=3)
    tr.close()


# ----------------------------------------------------- the loop under K > 1
def fake_step(calls: list, values=None):
    """A train_step that returns the state and fixed metrics at once."""
    def run_step(state, real, y, draws, *cfgs):
        calls.append(real.shape)
        draws.z(0)
        draws.idx(1)
        v = 1.0 if values is None else values[len(calls) - 1]
        return state, {k: torch.tensor(v) for k in LOSSES}
    return run_step


def test_loop_under_k_reads_the_device_only_at_log_steps(tmp_path,
                                                         monkeypatch):
    calls, reads = [], []
    monkeypatch.setattr(step_mod, "train_step", fake_step(calls))
    tr = make_trainer(tmp_path, total_step=8, log_step=4, steps_per_call=2)
    for name in ("item", "tolist", "__float__", "__int__", "__bool__",
                 "__index__", "numpy", "cpu"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **k):
            reads.append(len(calls))
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    tr.train()
    monkeypatch.undo()
    tr.close()
    assert calls == [(2, 4, 32, 32, 3)] * 8
    # log step 8 reads step 4's record; the end reads 8's and the metrics
    assert set(reads) == {8}


def test_nan_check_under_k_checks_the_call(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(step_mod, "train_step", fake_step(
        calls, [1.0, float("nan"), 3.0, 4.0]))
    tr = make_trainer(tmp_path, nan_check=True, steps_per_call=2)
    with pytest.raises(FloatingPointError, match="step 2"):
        tr.train()
    tr.close()
    assert len(calls) == 2 and not torch.is_anomaly_enabled()


def test_profile_window_is_aligned_to_k(tmp_path, monkeypatch):
    monkeypatch.setattr(step_mod, "train_step", fake_step([]))
    tr = make_trainer(tmp_path, total_step=16, log_step=4, profile=True,
                      steps_per_call=4)
    tr.train()
    tr.close()
    trace = json.load(open(tmp_path / "trace" / "steps_8_12.json"))
    assert trace["traceEvents"]
