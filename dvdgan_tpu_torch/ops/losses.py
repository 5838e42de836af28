"""Hinge GAN losses — the counterpart of `dvdgan_tpu/ops/losses.py`.

L_D = E[relu(1 − D(real))] + E[relu(1 + D(fake))], per discriminator;
L_G = −E[D(fake)]. No gradient penalty. All in float32.
"""

from __future__ import annotations

import torch


def d_hinge(real_scores: torch.Tensor, fake_scores: torch.Tensor
            ) -> torch.Tensor:
    return (torch.relu(1.0 - real_scores.float()).mean()
            + torch.relu(1.0 + fake_scores.float()).mean())


def g_hinge(fake_scores: torch.Tensor) -> torch.Tensor:
    return -fake_scores.float().mean()
