"""The port's frame-folder dataset and native clip ops
(`dvdgan_tpu_torch/data/frames.py`, `dvdgan_tpu_torch/native/`) against
the reference's (`dvdgan_tpu/data/frames.py`, `dvdgan_tpu/native/`), on
frame folders these tests write: the same clip bytes and labels for the
same seed, epoch and index (uint8 and float `.npy` under each
`npy_range`, PNG frames, GIF videos, clips shorter than T, a mid-epoch
resume through the loader), the reference's batches from the port's
loader, `clip_window` equal to the reference's and to the numpy path on
the shapes of `tests/test_native.py`, no build inside the package tree,
and `--dataset frames` through the port's CPU trainer and CLI.
`tests/test_data.py` and `tests/test_native.py` are the contracts.
"""

from __future__ import annotations

import builtins
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import dvdgan_tpu_torch
from dvdgan_tpu import native as jnative
from dvdgan_tpu.data import FrameFolderDataset as JFrames
from dvdgan_tpu.data import Loader as JLoader
from dvdgan_tpu_torch import cli, native
from dvdgan_tpu_torch.data import FrameFolderDataset, Loader
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(trainer_mod, "MetricWriter", functools.partial(
        plogging.MetricWriter, use_tensorboard=False))


def write_npy(root: Path, kind: str, n_classes: int = 3, n_videos: int = 2,
              t0: int = 10, h: int = 40, w: int = 52) -> Path:
    """root/<class>/<video>.npy clips of `kind`: uint8, or float in [0, 1]
    (unit) or [-1, 1] (symmetric)."""
    rng = np.random.RandomState(7)
    for c in range(n_classes):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for v in range(n_videos):
            u8 = rng.randint(0, 256, (t0 + v, h, w, 3), dtype=np.uint8)
            clip = {"uint8": u8,
                    "unit": u8.astype(np.float32) / 255.0,
                    "symmetric": u8.astype(np.float32) / 127.5 - 1.0}[kind]
            np.save(d / f"video_{v}.npy", clip)
    return root


def write_png(root: Path, n_classes: int = 2, n_videos: int = 2,
              t0: int = 7) -> Path:
    rng = np.random.RandomState(8)
    for c in range(n_classes):
        for v in range(n_videos):
            d = root / f"class_{c}" / f"video_{v}"
            d.mkdir(parents=True)
            for i in range(t0 + v):
                Image.fromarray(rng.randint(0, 256, (30, 38, 3),
                                            dtype=np.uint8)).save(
                    d / f"{i:05d}.png")
    return root


def assert_same_items(ours, ref, epochs=(0, 3)):
    assert len(ours) == len(ref) and ours.n_classes == ref.n_classes
    assert ours.classes == ref.classes
    for e in epochs:
        ours.set_epoch(e)
        ref.set_epoch(e)
        for i in range(len(ref)):
            (a, la), (b, lb) = ours[i], ref[i]
            assert la == lb
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), (e, i)


@pytest.mark.parametrize("kind,npy_range", [
    ("uint8", "auto"), ("unit", "auto"), ("symmetric", "auto"),
    ("unit", "unit"), ("symmetric", "symmetric")])
def test_npy_clips_match_the_reference(tmp_path, kind, npy_range):
    root = str(write_npy(tmp_path, kind))
    ours = FrameFolderDataset(root, 8, 32, seed=3, npy_range=npy_range)
    assert_same_items(ours, JFrames(root, 8, 32, seed=3,
                                    npy_range=npy_range))
    clip, _ = ours[0]
    assert clip.shape == (8, 32, 32, 3)
    assert clip.min() >= -1.0 and clip.max() <= 1.0


def test_png_frames_match_the_reference(tmp_path):
    root = str(write_png(tmp_path))
    assert_same_items(FrameFolderDataset(root, 4, 16, seed=1),
                      JFrames(root, 4, 16, seed=1))


def test_gif_videos_match_the_reference(tmp_path):
    # imageio's Pillow plugin decodes GIFs: no codec backend needed
    rng = np.random.RandomState(9)
    for c in range(2):
        (tmp_path / f"class_{c}").mkdir()
        frames = [Image.fromarray(rng.randint(0, 256, (20, 26, 3),
                                              dtype=np.uint8))
                  for _ in range(6 + c)]
        frames[0].save(tmp_path / f"class_{c}" / "video.gif", save_all=True,
                       append_images=frames[1:])
    assert_same_items(FrameFolderDataset(str(tmp_path), 4, 16, seed=2),
                      JFrames(str(tmp_path), 4, 16, seed=2))


def test_short_clips_are_looped_as_the_reference_loops_them(tmp_path):
    root = str(write_npy(tmp_path, "uint8", t0=3))
    ours = FrameFolderDataset(root, 8, 16, seed=2)
    assert_same_items(ours, JFrames(root, 8, 16, seed=2))
    clip, _ = ours[0]            # 3 frames looped to 8: frame i is i % 3
    np.testing.assert_array_equal(clip[3], clip[0])
    np.testing.assert_array_equal(clip[7], clip[1])


def test_loader_yields_the_reference_loaders_batches(tmp_path):
    root = str(write_npy(tmp_path, "uint8"))
    ours = Loader(FrameFolderDataset(root, 6, 24, seed=4), 2, seed=4,
                  num_threads=2)
    ref = JLoader(JFrames(root, 6, 24, seed=4), 2, seed=4, num_threads=2)
    try:
        # two epochs, and a stream resumed mid-epoch at epoch 1, batch 1
        a, b = ours.forever(), ref.forever()
        got = [next(a) for _ in range(6)]
        want = [next(b) for _ in range(6)]
        a.close()
        b.close()
        resumed = ours.forever(1, 1)
        again = [next(resumed) for _ in range(2)]
        resumed.close()
    finally:
        ours.close()
        ref.close()
    for (x, y), (u, v) in zip(got, want):
        assert x.tobytes() == u.tobytes() and np.array_equal(y, v)
    bpe = ours.batches_per_epoch()
    for (x, y), (u, v) in zip(again, want[bpe + 1:bpe + 3]):
        assert x.tobytes() == u.tobytes() and np.array_equal(y, v)


@pytest.mark.parametrize("shape,t,size,start", [
    ((10, 48, 64, 3), 4, 32, 2),     # rectangular, downresize
    ((6, 64, 64, 3), 6, 64, 0),      # identity size
    ((3, 32, 32, 3), 8, 16, 1),      # wrap-around window (loop pad)
    ((5, 17, 23, 3), 2, 8, 4),       # odd sizes
])
def test_clip_window_matches_the_reference_and_numpy(shape, t, size, start):
    assert native.available() and jnative.available()
    frames = np.random.RandomState(0).randint(0, 256, shape, dtype=np.uint8)
    got = native.clip_window(frames, t, size, start)
    assert got.tobytes() == jnative.clip_window(frames, t, size,
                                                start).tobytes()
    want = native.clip_window_numpy(frames, t, size, start)
    assert got.shape == want.shape == (t, size, size, 3)
    # the reference's tolerance (tests/test_native.py): the C++ scaling
    # table and numpy's divide may differ in the last bit
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_native_builds_outside_the_package_tree():
    package = Path(dvdgan_tpu_torch.__file__).parent.resolve()
    lib = native.library_path().resolve()
    assert native.available() and lib.exists()
    assert package not in lib.parents
    assert not list(package.rglob("libclipops*"))


def test_image_frames_without_pil_raise_and_say_so(tmp_path, monkeypatch):
    root = str(write_png(tmp_path, n_classes=1, n_videos=1))
    ds = FrameFolderDataset(root, 4, 16)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="needs PIL.*npy"):
        ds[0]


def test_npy_range_is_checked():
    with pytest.raises(ValueError, match="npy_range"):
        FrameFolderDataset(".", 4, 16, npy_range="sym")


TRAIN = ["--mode", "train", "--device", "cpu", "--img_size", "32",
         "--n_frames", "4", "--ch", "8", "--d_ch", "8", "--emb_dim", "16",
         "--attn_res", "16", "--k_frames", "2", "--batch_size", "2",
         "--d_steps", "1", "--bf16", "0", "--total_step", "2",
         "--log_step", "1", "--sample_step", "0", "--model_save_step", "2"]


def test_trainer_takes_frames_on_the_cpu(tmp_path, capsys):
    root = write_npy(tmp_path / "data", "uint8", h=48, w=40)
    state = cli.main([*TRAIN, "--dataset", "frames", "--data_path",
                      str(root), "--n_classes", "3", "--out_dir",
                      str(tmp_path / "run")])
    assert int(state["step"]) == 2
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["1", "2"]
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "2")


def test_trainer_checks_the_class_count(tmp_path):
    root = write_npy(tmp_path / "data", "uint8")
    with pytest.raises(ValueError, match="--n_classes 5 != 3 classes"):
        trainer_mod.Trainer(trainer_mod.Config(
            dataset="frames", data_path=str(root), n_classes=5,
            img_size=32, n_frames=4, ch=8, d_ch=8, emb_dim=16, attn_res=16,
            k_frames=2, batch_size=2, bf16=False, device="cpu",
            out_dir=str(tmp_path / "run")))


def test_importing_the_data_package_imports_no_decoder():
    # imageio is looked up at the first video file, PIL at the first image
    code = ("import sys, dvdgan_tpu_torch.data; "
            "print(sorted(m for m in ('PIL', 'imageio') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(dvdgan_tpu_torch.__file__).parents[1])
    assert out.stdout.strip() == "[]"
