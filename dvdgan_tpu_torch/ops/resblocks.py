"""Generator residual block — the counterpart of
`dvdgan_tpu/ops/resblocks.py:gresblock` (time folded into batch):

    main: CBN → ReLU → [upsample 2× → SNConv3×3, phase-decomposed]
          → CBN → ReLU → SNConv3×3
    skip: SNConv1×1 at LOW resolution (it commutes with nearest-up) → up 2×
          (identity conv when shape-preserving)
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


def gresblock(p: dict, stats: dict, x: torch.Tensor, cond: torch.Tensor,
              train: bool, upsample: bool):
    """x: (N, H, W, Cin), cond: (N, cond_dim) -> ((N, H', W', Cout), stats)."""
    h, s1 = norm.cbn(p["cbn1"], stats["bn1"], x, cond, train)
    h = torch.relu(h)
    if upsample:
        h = layers.upsample2x_conv3x3(p["conv1"], h)
    else:
        h = layers.conv2d(p["conv1"], h)
    h, s2 = norm.cbn(p["cbn2"], stats["bn2"], h, cond, train)
    h = torch.relu(h)
    h = layers.conv2d(p["conv2"], h)

    sc = x
    if "skip" in p:
        sc = layers.conv2d(p["skip"], sc)
    if upsample:
        sc = resize.upsample_nearest_2x(sc)
    return h + sc, {"bn1": s1, "bn2": s2}
