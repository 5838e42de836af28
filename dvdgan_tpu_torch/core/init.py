"""Weight initializers — the counterpart of `dvdgan_tpu/core/init.py`.

Every draw comes from an explicit CPU `torch.Generator`, so one seed gives
one set of weights on any device; callers move the result. The numbers
differ from `jax.random`'s for the same seed (the tests carry weights across
with `interop`, not by seed).
"""

from __future__ import annotations

import torch


def orthogonal(gen: torch.Generator, shape: tuple[int, ...],
               gain: float = 1.0) -> torch.Tensor:
    """Orthogonal init of an arbitrary-rank kernel, flattened to
    (prod(shape[:-1]), shape[-1]) as in the reference (HWIO kernels fold
    the receptive field and input channels)."""
    if len(shape) < 2:
        raise ValueError(f"orthogonal init needs rank>=2, got {shape}")
    n_rows = 1
    for d in shape[:-1]:
        n_rows *= d
    n_cols = shape[-1]
    a = torch.randn(max(n_rows, n_cols), min(n_rows, n_cols), generator=gen)
    q, r = torch.linalg.qr(a)
    # sign correction: uniform over the orthogonal group
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    return (gain * q).reshape(shape).contiguous()


def zeros(shape: tuple[int, ...]) -> torch.Tensor:
    return torch.zeros(shape)


def ones(shape: tuple[int, ...]) -> torch.Tensor:
    return torch.ones(shape)
