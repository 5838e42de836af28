"""Spatial resize — the counterpart of `dvdgan_tpu/ops/resize.py`
(the part the generator uses)."""

from __future__ import annotations

import torch


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C) by nearest-neighbour duplication."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)
