"""The trainer and checkpoints of the port (`train/trainer.py`,
`train/checkpoint.py`, `utils/{config,logging,media}.py`,
`tools/orbax_to_port_checkpoint.py`), on the CPU at the repo's test scale
(img 32, T 4, ch 8, batch 2, f32): checkpoints round-trip bitwise, the
async saver writes the synchronous save's bits, prunes, orders and
re-raises; resume is bitwise (2 steps, save, restore into another seed's
template, 2 steps equals 4 steps), the trainer resumes the data stream and
auto-resumes; the schedule writes its files at the flagged steps (the PNG
equal to the reference's `video_grid(denorm_uint8(.))`, the GIF within the
3-3-2 palette's half step); the loop reads the device only at log steps;
`sn_sigmas` against the reference (rtol 1e-5); the config has the
reference's fields; a reference Orbax checkpoint converts and resumes
bitwise. TensorBoard is off in the trainers here (its import takes
seconds); `scalars.jsonl` is checked.
"""

from __future__ import annotations

import functools
import io
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from dvdgan_tpu.core import tree as jtree
from dvdgan_tpu.ops import spectral_norm as jsn
from dvdgan_tpu.train import checkpoint as jckpt
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.utils import config as jconfig
from dvdgan_tpu.utils import logging as jlogging
from dvdgan_tpu.utils import media as jmedia
from dvdgan_tpu_torch import cli, interop
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.ops import spectral_norm as sn
from dvdgan_tpu_torch.train import checkpoint as ckpt
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step as step_mod
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging
from dvdgan_tpu_torch.utils import media
from dvdgan_tpu_torch.utils.config import Config
from tools import orbax_to_port_checkpoint

KW = dict(dataset="synthetic", n_classes=5, img_size=32, n_frames=4, ch=8,
          d_ch=8, emb_dim=16, attn_res=16, k_frames=2, batch_size=2,
          d_steps=1, bf16=False, ema_start=0, seed=5, device="cpu",
          log_step=100, sample_step=0, model_save_step=0)
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


def port_state(seed: int, step: int = 0) -> dict:
    cfg = Config(**KW)
    s = train_state.create(seed, cfg.g_config(), cfg.ds_config(),
                           cfg.dt_config())
    s["step"] = torch.tensor(step, dtype=torch.int32)
    return s


def flat(state: dict) -> dict[str, np.ndarray]:
    return interop.train_state_to_flat(state)


def assert_bitwise(a: dict, b: dict) -> None:
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        assert v.dtype == fb[k].dtype, k
        np.testing.assert_array_equal(v, fb[k], err_msg=k)


# ---------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_is_bitwise(tmp_path):
    st = port_state(0, step=7)
    d = str(tmp_path / "c")
    ckpt.save(d, 7, st)
    assert ckpt.latest_step(d) == 7
    restored = ckpt.restore(d, 7, port_state(99))
    assert_bitwise(restored, st)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 8, st)
    other = train_state.create(0, Config(**{**KW, "ch": 16}).g_config(),
                               Config(**KW).ds_config(),
                               Config(**KW).dt_config())
    with pytest.raises(ValueError, match="g/params"):
        ckpt.restore(d, 7, other)


def test_async_save_matches_sync_bitwise(tmp_path):
    st = port_state(0, step=5)
    ckpt.save(str(tmp_path / "sync"), 5, st)
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path / "async"), 5, st)
    # the snapshot is whole at save(): changing the state after it does not
    # reach the write
    tree.tree_map(lambda t: t.zero_(), st)
    saver.wait()
    a = ckpt.restore(str(tmp_path / "sync"), 5, port_state(1))
    b = ckpt.restore(str(tmp_path / "async"), 5, port_state(1))
    assert_bitwise(a, b)


def test_async_save_prunes_and_orders(tmp_path):
    saver = ckpt.AsyncSaver()
    d = str(tmp_path / "c")
    for s in (1, 2, 3):
        saver.save(d, s, port_state(s, step=s), max_to_keep=2)
    saver.wait()
    assert sorted(os.listdir(d)) == ["2", "3"]
    assert ckpt.latest_step(d) == 3
    for s in (2, 3):
        assert int(ckpt.restore(d, s, port_state(0))["step"]) == s


def test_async_save_error_surfaces(tmp_path):
    blocker = tmp_path / "c"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncSaver()
    saver.save(str(blocker), 1, port_state(0))
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.save(str(tmp_path / "ok"), 2, port_state(0))   # reusable after it
    saver.wait()
    assert ckpt.latest_step(str(tmp_path / "ok")) == 2


def test_latest_step_takes_the_max_and_ignores_temporary_dirs(tmp_path):
    d = tmp_path / "c"
    assert ckpt.latest_step(str(d)) is None
    assert ckpt.restore_latest(str(d), {"x": 1}) == (None, {"x": 1})
    for s in (3, 10):
        ckpt.save(str(d), s, port_state(0, step=s))
    (d / ".tmp-12-99").mkdir()           # a write that never finished
    (d / "12x").mkdir()
    assert ckpt.latest_step(str(d)) == 10
    step, st = ckpt.restore_latest(str(d), port_state(0))
    assert step == 10 and int(st["step"]) == 10


# --------------------------------------------------------------------- resume
@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """Four uninterrupted trainer steps on the schedule the tests read:
    log every 2 steps, samples and σ/γ every 2, checkpoints every 2 (keep
    1), gradient norms on."""
    out = tmp_path_factory.mktemp("a")
    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_mod, "MetricWriter", functools.partial(
        plogging.MetricWriter, use_tensorboard=False))
    try:
        tr = make_trainer(out, total_step=4, log_step=2, sample_step=2,
                          model_save_step=2, keep_checkpoints=1,
                          log_sigmas=True, log_grad_norms=True)
        tr.train()
        tr.close()
    finally:
        mp.undo()
    return out, tr


def test_resume_is_bitwise(run_a, tmp_path):
    """2 steps of `train_step` with the trainer's batches and draws, save,
    restore into a template from another seed, 2 more steps: the
    uninterrupted trainer's state, leaf for leaf."""
    _, tr_a = run_a
    tr = make_trainer(tmp_path / "b", log_grad_norms=True)
    bpe = tr.loader.batches_per_epoch()
    data = tr.loader.forever()
    try:
        batches = [next(data) for _ in range(4)]
    finally:
        data.close()
        tr.close()
    assert bpe > 4

    def steps(state, first, last):
        for i in range(first, last):
            draws = step_mod.TorchDraws(5, i, 2, tr.g_cfg.z_dim, 4, 2,
                                        torch.float32, "cpu")
            real, y = (torch.from_numpy(a) for a in batches[i])
            state, _ = step_mod.train_step(state, real, y.long(), draws,
                                           tr.g_cfg, tr.ds_cfg, tr.dt_cfg,
                                           tr.tc)
        return state

    st = steps(tr.state, 0, 2)
    ckpt.save(str(tmp_path / "ck"), 2, st)
    resumed_step, st = ckpt.restore_latest(str(tmp_path / "ck"),
                                           port_state(123))
    assert resumed_step == 2
    assert_bitwise(steps(st, 2, 4), tr_a.state)


def test_trainer_resumes_the_data_stream_and_auto_resumes(run_a, tmp_path):
    _, tr_a = run_a
    out = tmp_path / "b"
    tr = make_trainer(out, total_step=2, model_save_step=2)
    tr.train()
    tr.close()
    assert ckpt.latest_step(str(out / "checkpoints")) == 2
    tr = make_trainer(out, total_step=4, model_save_step=2,
                      log_grad_norms=True)       # auto-resumes from step 2
    assert tr.start_step == 2
    tr.train()
    tr.close()
    assert_bitwise(tr.state, tr_a.state)
    # --pretrained_model names a step; a missing one raises
    assert make_trainer(out, pretrained_model=2).start_step == 2
    with pytest.raises(FileNotFoundError):
        make_trainer(out, pretrained_model=3)


def test_draws_are_keyed_by_seed_and_step():
    def draws(seed, s):
        d = step_mod.TorchDraws(seed, s, 2, 120, 4, 2, torch.float32, "cpu")
        return d.z(0), d.idx(1), d.z(3)

    for a, b in zip(draws(5, 3), draws(5, 3)):
        assert torch.equal(a, b)
    assert not torch.equal(draws(5, 3)[0], draws(5, 4)[0])
    assert not torch.equal(draws(5, 3)[0], draws(6, 3)[0])
    # neighbouring seeds do not share streams shifted by a step
    assert not torch.equal(draws(5, 4)[0], draws(6, 3)[0])
    assert step_mod.step_seed(5, 3) < 2 ** 64


# ------------------------------------------------------------------- schedule
def test_schedule_writes_its_files_at_the_flagged_steps(run_a):
    out, tr = run_a
    assert os.listdir(out / "checkpoints") == ["4"]           # keep 1
    assert sorted(os.listdir(out / "samples")) == [
        f"{s}_{f}" for s in (2, 4)
        for f in ("grid.png", "sample0.gif", "sample1.gif")]
    # the last dump is of the final state: the reference's layout, exactly
    videos = tr.sample().numpy()
    want = jmedia.video_grid(jmedia.denorm_uint8(videos))
    png = np.asarray(Image.open(out / "samples" / "4_grid.png"))
    np.testing.assert_array_equal(png, want)
    gif = Image.open(out / "samples" / "4_sample1.gif")
    frames = []
    for i in range(gif.n_frames):
        gif.seek(i)
        frames.append(np.asarray(gif.convert("RGB"), np.int32))
    ref = jmedia.denorm_uint8(videos[1]).astype(np.int32)
    assert np.stack(frames).shape == ref.shape
    # each channel within half a palette step: 8 levels of r, g; 4 of b
    gap = np.abs(np.stack(frames) - ref).max(axis=(0, 1, 2))
    assert np.all(gap <= np.ceil(np.array([255 / 7, 255 / 7, 255 / 3]) / 2))


def test_scalars_have_the_reference_record_keys(run_a, tmp_path):
    out, _ = run_a
    records = [json.loads(ln) for ln in
               open(out / "logs" / "scalars.jsonl").read().splitlines()]
    ref = jlogging.MetricWriter(str(tmp_path), use_tensorboard=False)
    ref.scalar("x", 1.0, 1)
    ref.close()
    ref_keys = set(json.loads(open(tmp_path / "scalars.jsonl").readline()))
    assert all(set(r) == ref_keys for r in records)
    by_step: dict[int, set] = {}
    for r in records:
        by_step.setdefault(r["step"], set()).add(r["tag"])
    assert sorted(by_step) == [2, 4]
    for s in (2, 4):
        tags = by_step[s]
        assert {*LOSSES, "steps_per_sec", "d_grad_norm",
                "g_grad_norm"} <= tags
        assert "sigma/g/levels/0/gru/gates_h/w" in tags
        assert "gamma/g/attn/spatial/gamma" in tags
        assert any(t.startswith("sigma/ds/") for t in tags)
        assert any(t.startswith("sigma/dt/") for t in tags)
    sps = [r["value"] for r in records if r["tag"] == "steps_per_sec"]
    assert len(sps) == 2 and all(v > 0 for v in sps)


def test_sample_mode_reads_the_checkpoints(run_a, tmp_path):
    """Sample mode takes EMA-G from --pretrained_model, --weights (not
    both) or the newest checkpoint, and writes the grid and GIFs."""
    out, _ = run_a
    shutil.copytree(out / "checkpoints", tmp_path / "checkpoints")
    flags = ["--mode", "sample", "--n_samples", "2", "--out_dir",
             str(tmp_path)] + [a for k, v in KW.items()
                               if k not in ("log_step", "sample_step",
                                            "model_save_step", "bf16")
                               for a in (f"--{k}", str(v))] + ["--bf16", "0"]
    newest = cli.main(flags)
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "4_sample0.gif", "4_sample1.gif", "eval_4_grid.png"]
    pinned = cli.main(flags + ["--pretrained_model", "4"])
    weights = cli.main(flags + ["--weights", str(
        tmp_path / "checkpoints" / "4" / ckpt.STATE_FILE)])
    np.testing.assert_array_equal(pinned, newest)
    np.testing.assert_array_equal(weights, newest)
    with pytest.raises(ValueError, match="pass one"):
        cli.main(flags + ["--pretrained_model", "4", "--weights", "w.npz"])
    with pytest.raises(FileNotFoundError):
        cli.main(flags + ["--pretrained_model", "3"])


def test_media_writers_decode():
    rng = np.random.RandomState(0)
    videos = np.tanh(rng.randn(2, 3, 37, 29, 3)).astype(np.float32)
    grid = media.video_grid(media.denorm_uint8(videos))
    np.testing.assert_array_equal(
        grid, jmedia.video_grid(jmedia.denorm_uint8(videos)))
    png = Image.open(io.BytesIO(media.encode_png(grid)))
    np.testing.assert_array_equal(np.asarray(png), grid)
    # noise: the LZW table is cleared several times within a frame
    frames = media.denorm_uint8(np.tanh(rng.randn(2, 90, 80, 3)))
    gif = Image.open(io.BytesIO(media.encode_gif(frames)))
    got = []
    for i in range(gif.n_frames):
        gif.seek(i)
        got.append(np.asarray(gif.convert("RGB")))
    np.testing.assert_array_equal(
        np.stack(got), media.PALETTE[media.palette_indices(frames)])


# ----------------------------------------------------------------- the loop
def fake_step(calls: list, values=None):
    """A train_step that returns the state and fixed metrics at once."""
    def run(state, real, y, draws, *cfgs):
        calls.append(real.shape)
        draws.z(0)
        draws.idx(1)
        v = 1.0 if values is None else values[len(calls) - 1]
        return state, {k: torch.tensor(v) for k in LOSSES}
    return run


def test_loop_reads_the_device_only_at_log_steps(tmp_path, monkeypatch):
    calls, reads = [], []
    monkeypatch.setattr(step_mod, "train_step", fake_step(calls))
    tr = make_trainer(tmp_path, total_step=7, log_step=2)
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
    assert len(calls) == 7
    # log steps 4 and 6 read the records of steps 2 and 4; the end reads 6's
    # and the last step's metrics: no other step reads a tensor
    assert set(reads) == {4, 6, 7}


def test_nan_check_raises_at_the_first_non_finite_step(tmp_path,
                                                       monkeypatch):
    calls = []
    monkeypatch.setattr(step_mod, "train_step", fake_step(
        calls, [1.0, 2.0, float("nan"), 4.0]))
    tr = make_trainer(tmp_path, total_step=4, nan_check=True)
    with pytest.raises(FloatingPointError, match="step 3"):
        tr.train()
    tr.close()
    assert len(calls) == 3 and not torch.is_anomaly_enabled()


def test_profile_traces_steps_10_to_15(tmp_path, monkeypatch):
    monkeypatch.setattr(step_mod, "train_step", fake_step([]))
    tr = make_trainer(tmp_path, total_step=16, profile=True)
    tr.train()
    tr.close()
    trace = json.load(open(tmp_path / "trace" / "steps_10_15.json"))
    assert trace["traceEvents"]


# --------------------------------------------------------- config, σ, orbax
def test_config_has_every_reference_field_with_its_default():
    import dataclasses
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    assert set(ours) - set(ref) == {"weights", "device", "ups_fused",
                                    "attn_fused", "remat_save"}
    assert {k: ours[k] for k in ref} == ref


@pytest.mark.parametrize("change,item", [
    (dict(time_shards=2), "item 6"),
    (dict(multihost=True), "item 6"),
    (dict(n_devices=2), "item 6"),
], ids=["change1-item 6", "change4-item 6", "change5-item 6"])
def test_a_flag_whose_item_is_not_ported_raises(change, item, tmp_path):
    """Queue 1 item 6 is ported: a Trainer built without its rank's
    process group (`Trainer(cfg, par)`, which the CLI gives each rank)
    refuses the multi-rank flags before it writes anything."""
    with pytest.raises(ValueError, match="one process a rank"):
        make_trainer(tmp_path / "o", **change)
    assert not (tmp_path / "o").exists()


def test_sn_sigmas_match_reference():
    rng = np.random.RandomState(0)
    params = {"conv": {"w": rng.randn(3, 3, 6, 8).astype(np.float32),
                       "b": rng.randn(8).astype(np.float32)},
              "emb": [rng.randn(5, 16).astype(np.float32)]}
    u = {"conv/w": rng.randn(8).astype(np.float32),
         "emb/0": rng.randn(16).astype(np.float32)}
    u = {k: v / np.linalg.norm(v) for k, v in u.items()}
    ref = jsn.sn_sigmas(jax.tree.map(jnp.asarray, params),
                        {k: jnp.asarray(v) for k, v in u.items()})
    ours = sn.sn_sigmas(tree.tree_map(torch.from_numpy, params),
                        {k: torch.from_numpy(v) for k, v in u.items()})
    assert ours.keys() == ref.keys()
    for k, v in ours.items():
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


def test_orbax_checkpoint_converts_and_resumes_bitwise(tmp_path):
    """A reference train state saved by `dvdgan_tpu.train.checkpoint.save`,
    converted by the tool, restores in the port and resumes through
    --pretrained_model with the reference's leaves, bit for bit."""
    cfg = jconfig.Config(**{k: v for k, v in KW.items() if k != "device"})
    abstract = jax.eval_shape(
        lambda key: jstate.create(key, cfg.g_config(), cfg.ds_config(),
                                  cfg.dt_config(), cfg.train_config()),
        jax.random.PRNGKey(0))
    values = flat(port_state(3, step=5))
    rng = np.random.RandomState(1)
    for k, v in values.items():              # off the init: every leaf moves
        if v.dtype == np.float32:
            values[k] = v + np.float32(rng.randn(*v.shape))
    paths = [jtree.path_str(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(abstract)[0]]
    ref = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(abstract),
                                       [values[p] for p in paths])
    jckpt.save(str(tmp_path / "ref" / "checkpoints"), 5, ref)
    flags = [a for k, v in KW.items() if k not in ("device", "bf16")
             for a in (f"--{k}", str(v))]
    out = orbax_to_port_checkpoint.main(
        [*flags, "--bf16", "0", "--out_dir", str(tmp_path / "ref"),
         "--port_out_dir", str(tmp_path / "port")])
    assert out == str(tmp_path / "port" / "checkpoints" / "5")
    want = {k: np.asarray(v) for k, v in jtree.flatten_with_paths(ref).items()}
    got = flat(ckpt.restore(str(tmp_path / "port" / "checkpoints"), 5,
                            port_state(0)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    tr = make_trainer(tmp_path / "port", pretrained_model=5)
    assert tr.start_step == 5
    for k, v in flat(tr.state).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tr.close()
