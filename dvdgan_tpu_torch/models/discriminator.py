"""Dual discriminators DS / DT — the counterpart of
`dvdgan_tpu/models/discriminator.py`.

DS (spatial) scores k sampled full-resolution frames per clip with a 2-D
BigGAN-D ResNet (DBlocks down to 4×4, a final non-downsampling block, ReLU,
global sum-pool, SNLinear head) plus projection conditioning
(+ embed(y)·features); the k per-frame scores are summed per clip.

DT (temporal) takes the whole clip at half resolution (the φ 2× mean pool,
done here unless the caller already did it: `pooled=True`); its first
`n_3d_blocks` blocks are 3×3×3 convs with spatial-only pooling, the rest
are 2-D blocks with time folded into batch; same head, scores summed over
frames. Both return one score per clip, (B,).

Parameters are trees of the reference's paths ("blocks/0/conv1/w",
"head/psi/w", "head/proj/emb"), HWIO/DHWIO kernels.
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch.models.config import DSConfig, DTConfig
from dvdgan_tpu_torch.ops import layers, resblocks, resize


def _head_init(gen: torch.Generator, feat_dim: int, n_classes: int) -> dict:
    return {
        "psi": layers.linear_init(gen, feat_dim, 1),
        "proj": layers.embedding_init(gen, n_classes, feat_dim),
    }


def _head(p: dict, feats: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Projection head. feats: (N, F); y: (N,) -> (N,)."""
    out = layers.linear(p["psi"], feats)[..., 0]
    emb = layers.embedding(p["proj"], y).to(feats.dtype)
    return out + (emb * feats).sum(dim=-1)


def ds_init(gen: torch.Generator, cfg: DSConfig) -> dict:
    """DS params on the CPU, drawn from `gen`."""
    m = cfg.mults
    blocks = [resblocks.dblock_init(gen, 3, cfg.ch * m[0], first=True)]
    for i in range(1, len(m)):
        blocks.append(resblocks.dblock_init(gen, cfg.ch * m[i - 1],
                                            cfg.ch * m[i]))
    return {"blocks": blocks,
            "head": _head_init(gen, cfg.feat_dim, cfg.n_classes)}


def ds_apply(params: dict, frames: torch.Tensor, y: torch.Tensor,
             cfg: DSConfig) -> torch.Tensor:
    """frames: (B, k, H, W, 3); y: (B,) -> per-clip score (B,)."""
    b, k = frames.shape[:2]
    x = frames.reshape(b * k, *frames.shape[2:])
    n_down = len(cfg.mults) - 1     # the final block keeps the resolution
    for i, blk in enumerate(params["blocks"]):
        x = resblocks.dblock(blk, x, down=(i < n_down), first=(i == 0))
    feats = resize.global_sum_pool(torch.relu(x))              # (B·k, F)
    scores = _head(params["head"], feats, y.repeat_interleave(k))
    return scores.reshape(b, k).sum(dim=1)


def dt_init(gen: torch.Generator, cfg: DTConfig) -> dict:
    """DT params on the CPU, drawn from `gen`."""
    m = cfg.mults
    blocks = []
    for i in range(len(m)):
        cin = 3 if i == 0 else cfg.ch * m[i - 1]
        cout = cfg.ch * m[i]
        if i < cfg.n_3d_blocks:
            blocks.append(resblocks.dblock3d_init(gen, cin, cout,
                                                  first=(i == 0)))
        else:
            blocks.append(resblocks.dblock_init(gen, cin, cout))
    return {"blocks": blocks,
            "head": _head_init(gen, cfg.feat_dim, cfg.n_classes)}


def dt_apply(params: dict, clip: torch.Tensor, y: torch.Tensor,
             cfg: DTConfig, pooled: bool = False) -> torch.Tensor:
    """clip: (B, T, H, W, 3) at full resolution — or at half resolution
    with `pooled=True` (φ already applied; it is per-frame and linear, so
    pooling once outside is the same) — y: (B,) -> (B,)."""
    b, t = clip.shape[:2]
    n_down = len(cfg.mults) - 1
    x = clip if pooled else resize.avg_pool_2x_video(clip)
    n3 = cfg.n_3d_blocks
    for i, blk in enumerate(params["blocks"][:n3]):
        x = resblocks.dblock3d(blk, x, down=(i < n_down), first=(i == 0))
    x = x.reshape(b * t, *x.shape[2:])                         # fold time
    for i, blk in enumerate(params["blocks"][n3:], start=n3):
        x = resblocks.dblock(blk, x, down=(i < n_down))
    feats = resize.global_sum_pool(torch.relu(x))              # (B·T, F)
    scores = _head(params["head"], feats, y.repeat_interleave(t))
    return scores.reshape(b, t).sum(dim=1)
