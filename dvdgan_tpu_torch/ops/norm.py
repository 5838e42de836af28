"""Batch normalization, plain and class-conditional — the counterpart of
`dvdgan_tpu/ops/norm.py`.

Functional, with the running moments in an explicit {'mean', 'var'} state
dict. Moment math is float32; the running variance stores the BIASED batch
variance (as the reference does, and unlike `nn.BatchNorm2d`, which is
therefore not used). The per-element normalization runs in the activation
dtype, with mean and 1/σ rounded to it first.

Cross-replica BN: with a process `group` (`parallel/mesh.py`'s data group)
the batch mean and E[x²] — not the variance — are averaged over the group's
ranks in f32 through `parallel.collectives.all_mean`, whose backward
averages the cotangents the same way, as the reference's `pmean` under
`shard_map` does. With `group=None` nothing changes.
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch.core import init as winit
from dvdgan_tpu_torch.ops import layers
from dvdgan_tpu_torch.parallel import collectives


def _batch_moments(x: torch.Tensor, group=None):
    """Biased mean/var over all but the channel axis, float32, the mean and
    E[x²] averaged over `group` (one all-reduce of both)."""
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = x32.mean(axes)
    mean_sq = (x32 * x32).mean(axes)
    if group is not None:
        mean, mean_sq = collectives.all_mean(torch.stack([mean, mean_sq]),
                                             group).unbind(0)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    return mean, var


def _normalize(x, mean, var, eps):
    inv = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * inv.to(x.dtype)


def stats_init(c: int) -> dict:
    return {"mean": winit.zeros((c,)), "var": winit.ones((c,))}


def _select_moments(stats, x, train, momentum, group):
    if train:
        mean, var = _batch_moments(x, group)
        new_stats = {
            "mean": (1.0 - momentum) * stats["mean"] + momentum * mean,
            "var": (1.0 - momentum) * stats["var"] + momentum * var,
        }
        return mean, var, new_stats
    return stats["mean"], stats["var"], stats


def bn_init(c: int) -> dict:
    return {"scale": winit.ones((c,)), "bias": winit.zeros((c,))}


def bn(p: dict, stats: dict, x: torch.Tensor, train: bool,
       momentum: float = 0.1, eps: float = 1e-5, group=None):
    """(y, new_stats). x: (..., C)."""
    mean, var, new_stats = _select_moments(stats, x, train, momentum, group)
    y = _normalize(x, mean, var, eps)
    y = y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    return y, new_stats


def cbn_init(gen: torch.Generator, cond_dim: int, c: int) -> dict:
    # γ = 1 + W_g·cond, β = W_b·cond: zero-centred maps without bias, so init
    # behaves like identity BN; kernels named 'w' are spectrally normalized.
    return {
        "gamma": layers.linear_init(gen, cond_dim, c, use_bias=False),
        "beta": layers.linear_init(gen, cond_dim, c, use_bias=False),
    }


def cbn(p: dict, stats: dict, x: torch.Tensor, cond: torch.Tensor,
        train: bool, momentum: float = 0.1, eps: float = 1e-5, group=None):
    """(y, new_stats). x: (N, H, W, C); cond: (N, cond_dim) per-sample
    affine. Callers with time folded into batch repeat cond over T first."""
    mean, var, new_stats = _select_moments(stats, x, train, momentum, group)
    y = _normalize(x, mean, var, eps)
    gamma = 1.0 + layers.linear(p["gamma"], cond)     # (N, C) in x.dtype
    beta = layers.linear(p["beta"], cond)
    y = y * gamma[:, None, None, :] + beta[:, None, None, :]
    return y, new_stats
