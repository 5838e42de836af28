"""Context parallelism over the clip's time axis for DT — the counterpart
of `dvdgan_tpu/parallel/time_shard.py`.

Each rank of a time group holds a window of T/n frames of DT's clip:

  * the first `n_3d_blocks` residual blocks run 3×3×3 convs, so each conv
    takes one frame of halo on each side from its neighbours
    (`collectives.halos`, zero frames at the clip's two ends) and runs
    VALID over time, SAME over space;
  * the 2-D per-frame tail and the score head are local;
  * the per-clip score is the `all_sum` of the ranks' frame-score sums, so
    every rank of the group holds the whole clip's score.

The reference's temporal output-pair branch (`conv3d_tpair_core`) only
steers XLA onto the TPU's matrix lanes and has no counterpart here.

φ, the 2× spatial mean pool, is per frame, so pooling the whole clip and
then taking the window gives the same bits as pooling the window: with
`pooled=True` the window is taken from an already pooled clip
(`train/step.py` keeps its D-phase pre-pool under time sharding).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dvdgan_tpu_torch.models.config import DTConfig
from dvdgan_tpu_torch.models.discriminator import _head
from dvdgan_tpu_torch.ops import layers, resblocks, resize
from dvdgan_tpu_torch.parallel import collectives


def window(clip: torch.Tensor, group) -> torch.Tensor:
    """This rank's T/n frames of `clip` (B, T, ...) along the time
    group's rank order."""
    n = collectives.size(group)
    if n == 1:
        return clip
    t = clip.shape[1]
    if t % n:
        raise ValueError(f"clip length {t} not divisible by the time axis "
                         f"({n} shards)")
    tl = t // n
    i = dist.get_rank(group)
    return clip[:, i * tl:(i + 1) * tl]


def _conv3d_halo(p: dict, x: torch.Tensor, group) -> torch.Tensor:
    """3×3×3 SAME conv over the time-sharded clip x (B, T_local, H, W, C):
    the halos, then the conv VALID over time and SAME over space."""
    left, right = collectives.halos(x, group)
    xh = torch.cat([left[:, None], x, right[:, None]], dim=1)
    w = p["w"].to(x.dtype)
    y = F.conv3d(xh.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=(0, 1, 1))
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _dblock3d_sharded(p: dict, x: torch.Tensor, down: bool, first: bool,
                      group) -> torch.Tensor:
    """`resblocks.dblock3d` with halo-exchanged convs, in the reference's
    order (`time_shard.py:81-100`): the first block pools its skip before
    the 1×1×1 conv, the others after it."""
    h = x if first else torch.relu(x)
    h = _conv3d_halo(p["conv1"], h, group)
    h = torch.relu(h)
    h = _conv3d_halo(p["conv2"], h, group)
    if down:
        h = resize.avg_pool_2x_video(h)
    sc = x
    if first:
        if down:
            sc = resize.avg_pool_2x_video(sc)
        if "skip" in p:
            sc = layers.conv3d(p["skip"], sc)      # 1×1×1: no halo
    else:
        if "skip" in p:
            sc = layers.conv3d(p["skip"], sc)
        if down:
            sc = resize.avg_pool_2x_video(sc)
    return h + sc


def dt_apply_time_sharded(params: dict, clip_shard: torch.Tensor,
                          y: torch.Tensor, cfg: DTConfig, group,
                          pooled: bool = False) -> torch.Tensor:
    """Time-sharded DT forward on this rank's window clip_shard (B, T/n, H,
    W, 3) at full resolution (or φ-pooled with `pooled=True`) -> the
    per-clip score (B,), the same on every rank of `group`."""
    b, tl = clip_shard.shape[:2]
    n_down = len(cfg.mults) - 1
    n3 = cfg.n_3d_blocks
    x = clip_shard if pooled else resize.avg_pool_2x_video(clip_shard)
    for i, blk in enumerate(params["blocks"][:n3]):
        x = _dblock3d_sharded(blk, x, down=(i < n_down), first=(i == 0),
                              group=group)
    x = x.reshape(b * tl, *x.shape[2:])
    for i, blk in enumerate(params["blocks"][n3:], start=n3):
        x = resblocks.dblock(blk, x, down=(i < n_down))
    feats = resize.global_sum_pool(torch.relu(x))
    scores = _head(params["head"], feats, y.repeat_interleave(tl))
    return collectives.all_sum(scores.reshape(b, tl).sum(dim=1), group)


def make_sharded_dt(params: dict, cfg: DTConfig, group,
                    pooled: bool = False):
    """f(clip, y): the whole clip (B, T, H, W, 3) in (φ-pooled with
    `pooled`), the scores out, this rank scoring its window of it (the
    reference's `make_sharded_dt`; `train/step.py`'s DT under `time`)."""
    def fn(clip: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return dt_apply_time_sharded(params, window(clip, group), y, cfg,
                                     group, pooled=pooled)
    return fn
