"""Synthetic video source: procedurally generated class-conditional clips
— a copy of `dvdgan_tpu/data/synthetic.py` (numpy only; the same seed gives
the same clips and labels).

Clips are "moving square" videos whose motion direction/speed is a
deterministic function of the class id and whose start position/color comes
from the per-clip seed — enough signal for the GAN smoke configs to have
something learnable, and fully deterministic for tests. Generated with numpy
on the host; the train loop moves batches to the device.
"""

from __future__ import annotations

import numpy as np


def make_clip(seed: int, label: int, t: int, size: int,
              n_classes: int) -> np.ndarray:
    """One clip (T, H, W, 3) float32 in [-1, 1]."""
    rng = np.random.RandomState(seed)
    angle = 2.0 * np.pi * label / max(n_classes, 1)
    speed = 1.0 + (label % 3)
    dx, dy = speed * np.cos(angle), speed * np.sin(angle)
    sq = max(size // 8, 2)
    x0 = rng.uniform(sq, size - 2 * sq)
    y0 = rng.uniform(sq, size - 2 * sq)
    color = rng.uniform(0.2, 1.0, size=(3,)).astype(np.float32)
    bg = rng.uniform(-1.0, -0.5)

    clip = np.full((t, size, size, 3), bg, np.float32)
    for i in range(t):
        cx = int(x0 + dx * i) % (size - sq)
        cy = int(y0 + dy * i) % (size - sq)
        clip[i, cy:cy + sq, cx:cx + sq, :] = color
    return clip


class SyntheticVideoDataset:
    """Map-style dataset: __len__ / __getitem__ -> (clip, label).

    API parity with the reference's torch Dataset ([R dataset.py]) without
    the torch dependency.
    """

    def __init__(self, n_items: int, n_frames: int, img_size: int,
                 n_classes: int, seed: int = 0):
        self.n_items = n_items
        self.n_frames = n_frames
        self.img_size = img_size
        self.n_classes = n_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.n_items

    def __getitem__(self, idx: int):
        label = idx % self.n_classes
        clip = make_clip(self.seed * 1_000_003 + idx, label,
                         self.n_frames, self.img_size, self.n_classes)
        return clip, label
