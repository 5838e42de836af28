"""Spatial resize and pooling — the counterpart of `dvdgan_tpu/ops/resize.py`
(channels-last).

The 2×2 mean pools accumulate in the activation dtype, as the reference's
do (`mean(dtype=x.dtype)`): three adds rounded to that dtype, in row-major
order (the order XLA's reduce takes on the CPU, so bf16 pools match the
reference bitwise there), then × 1/4, which is exact. `Tensor.mean(dtype=…)`
is not that: PyTorch accumulates a bf16 mean in f32 and rounds once."""

from __future__ import annotations

import torch


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C) by nearest-neighbour duplication."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def _mean_2x2(x: torch.Tensor) -> torch.Tensor:
    """(..., H/2, 2, W/2, 2, C) -> (..., H/2, W/2, C)."""
    x00, x01 = x[..., 0, :, 0, :], x[..., 0, :, 1, :]
    x10, x11 = x[..., 1, :, 0, :], x[..., 1, :, 1, :]
    return (((x00 + x01) + x10) + x11) * 0.25


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, C) 2×2 mean pool."""
    n, h, w, c = x.shape
    return _mean_2x2(x.reshape(n, h // 2, 2, w // 2, 2, c))


def avg_pool_2x_video(x: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) -> (N, T, H/2, W/2, C): DT's input transform φ
    (spatial only; also valid for the time-major layout)."""
    n, t, h, w, c = x.shape
    return _mean_2x2(x.reshape(n, t, h // 2, 2, w // 2, 2, c))


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C) sum over the spatial grid (the D head)."""
    return x.sum(dim=(1, 2))
