"""Sampling — the counterpart of `dvdgan_tpu/train/step.py:sample`.
The train step lands with the training slice (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

import torch

from dvdgan_tpu_torch.models import GConfig
from dvdgan_tpu_torch.models import generator
from dvdgan_tpu_torch.ops import spectral_norm as sn


@torch.no_grad()
def sample(g_params_ema: dict, g_stats: dict, sn_u: dict, z: torch.Tensor,
           y: torch.Tensor, g_cfg: GConfig) -> torch.Tensor:
    """The serving path: EMA weights, eval-mode BN (running stats), SN with
    frozen u (one power iteration, u not stored back), everything in the
    compute dtype z.dtype. Returns (B, T, H, W, 3) in [-1, 1]."""
    g_sn, _ = sn.sn_normalize(g_params_ema, sn_u, update=False,
                              compute_dtype=z.dtype)
    video, _ = generator.apply(g_sn, g_stats, z, y, g_cfg, train=False)
    return video
