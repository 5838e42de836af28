"""Residual blocks — the counterpart of `dvdgan_tpu/ops/resblocks.py`.

GResBlock (time folded into batch):

    main: CBN → ReLU → [upsample 2× → SNConv3×3, phase-decomposed]
          → CBN → ReLU → SNConv3×3
    skip: SNConv1×1 at LOW resolution (it commutes with nearest-up) → up 2×
          (identity conv when shape-preserving)

DBlock (2-D) and DBlock3D (3×3×3 convs, spatial-only pooling), BigGAN-D
pre-activation blocks:

    main: [ReLU unless first] → SNConv3×3 → ReLU → SNConv3×3 → [avg-pool 2×]
    skip: [avg-pool 2×] → SNConv1×1 (when first or the width changes)

The skip pools before its 1×1 conv (the two commute exactly), in the
reference's order, so the summation order matches too.
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch.ops import layers, norm, resize


def gresblock_init(gen: torch.Generator, cin: int, cout: int, cond_dim: int
                   ) -> dict:
    p = {
        "cbn1": norm.cbn_init(gen, cond_dim, cin),
        "conv1": layers.conv2d_init(gen, 3, cin, cout),
        "cbn2": norm.cbn_init(gen, cond_dim, cout),
        "conv2": layers.conv2d_init(gen, 3, cout, cout),
    }
    if cin != cout:
        p["skip"] = layers.conv2d_init(gen, 1, cin, cout)
    return p


def gresblock_stats_init(cin: int, cout: int) -> dict:
    return {"bn1": norm.stats_init(cin), "bn2": norm.stats_init(cout)}


def gresblock_pre(p: dict, stats: dict, x: torch.Tensor, cond: torch.Tensor,
                  train: bool, group=None):
    """The block before its first conv: CBN → ReLU.
    -> ((N, H, W, Cin), bn1 stats)."""
    h, s1 = norm.cbn(p["cbn1"], stats["bn1"], x, cond, train, group=group)
    return torch.relu(h), s1


def gresblock_conv1(p: dict, h: torch.Tensor, upsample: bool,
                    ups_fused: str = "off") -> torch.Tensor:
    """The block's first conv (the reference's `ups_out` when upsampling);
    `ups_fused` is the upsample conv's route (`layers.upsample2x_conv3x3`)."""
    if upsample:
        return layers.upsample2x_conv3x3(p["conv1"], h, ups_fused)
    return layers.conv2d(p["conv1"], h)


def gresblock_head(p: dict, stats: dict, x: torch.Tensor, cond: torch.Tensor,
                   train: bool, upsample: bool, ups_fused: str = "off",
                   group=None):
    """The block up to its first conv's output: CBN → ReLU → conv1.
    -> ((N, H', W', Cout), bn1 stats)."""
    h, s1 = gresblock_pre(p, stats, x, cond, train, group)
    return gresblock_conv1(p, h, upsample, ups_fused), s1


def gresblock_tail(p: dict, stats: dict, h: torch.Tensor, x: torch.Tensor,
                   cond: torch.Tensor, train: bool, upsample: bool,
                   group=None):
    """The rest of the block, from conv1's output `h` and the block input
    `x`: CBN → ReLU → conv2, plus the skip. -> ((N, H', W', Cout), bn2
    stats)."""
    h, s2 = norm.cbn(p["cbn2"], stats["bn2"], h, cond, train, group=group)
    h = torch.relu(h)
    h = layers.conv2d(p["conv2"], h)

    sc = x
    if "skip" in p:
        sc = layers.conv2d(p["skip"], sc)
    if upsample:
        sc = resize.upsample_nearest_2x(sc)
    return h + sc, s2


def gresblock(p: dict, stats: dict, x: torch.Tensor, cond: torch.Tensor,
              train: bool, upsample: bool, ups_fused: str = "off",
              group=None):
    """x: (N, H, W, Cin), cond: (N, cond_dim) -> ((N, H', W', Cout), stats).
    Head and tail are separate functions so that a rematerializing caller
    can keep conv1's output and recompute the rest (`models/generator.py`).
    `group`: the process group of cross-replica BN (`ops/norm.py`)."""
    h, s1 = gresblock_head(p, stats, x, cond, train, upsample, ups_fused,
                           group)
    out, s2 = gresblock_tail(p, stats, h, x, cond, train, upsample, group)
    return out, {"bn1": s1, "bn2": s2}


def dblock_init(gen: torch.Generator, cin: int, cout: int, first: bool = False
                ) -> dict:
    p = {
        "conv1": layers.conv2d_init(gen, 3, cin, cout),
        "conv2": layers.conv2d_init(gen, 3, cout, cout),
    }
    if first or cin != cout:
        p["skip"] = layers.conv2d_init(gen, 1, cin, cout)
    return p


def dblock(p: dict, x: torch.Tensor, down: bool, first: bool = False
           ) -> torch.Tensor:
    """x: (N, H, W, Cin) -> (N, H', W', Cout)."""
    h = x if first else torch.relu(x)
    h = layers.conv2d(p["conv1"], h)
    h = torch.relu(h)
    h = layers.conv2d(p["conv2"], h)
    sc = x
    if down:
        h = resize.avg_pool_2x(h)
        sc = resize.avg_pool_2x(sc)
    if "skip" in p:
        sc = layers.conv2d(p["skip"], sc)
    return h + sc


def dblock3d_init(gen: torch.Generator, cin: int, cout: int,
                  first: bool = False) -> dict:
    p = {
        "conv1": layers.conv3d_init(gen, (3, 3, 3), cin, cout),
        "conv2": layers.conv3d_init(gen, (3, 3, 3), cout, cout),
    }
    if first or cin != cout:
        p["skip"] = layers.conv3d_init(gen, (1, 1, 1), cin, cout)
    return p


def dblock3d(p: dict, x: torch.Tensor, down: bool, first: bool = False
             ) -> torch.Tensor:
    """x: (N, T, H, W, Cin) -> (N, T, H', W', Cout)."""
    h = x if first else torch.relu(x)
    h = layers.conv3d(p["conv1"], h)
    h = torch.relu(h)
    h = layers.conv3d(p["conv2"], h)
    sc = x
    if down:
        h = resize.avg_pool_2x_video(h)
        sc = resize.avg_pool_2x_video(sc)
    if "skip" in p:
        sc = layers.conv3d(p["skip"], sc)
    return h + sc
