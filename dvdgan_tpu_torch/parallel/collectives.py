"""Differentiable collectives over `torch.distributed` process groups — the
port's counterparts of the reference's `lax.pmean`, `lax.psum` and
`lax.ppermute` inside `shard_map(check_vma=False)`.

A plain `dist.all_reduce` is invisible to autograd: used inside a loss it
drops the cross-replica term of the gradient (BN's batch moments, DT's
score). So each collective here is a `torch.autograd.Function` whose
backward is the reference's transpose under `check_vma=False`:

  * `all_mean(x, group)`: SUM all-reduce divided by the group's size;
    its backward all-reduces the cotangent the same way (`pmean`
    transposes to `pmean`);
  * `all_sum(x, group)`: the same without the division (`psum` → `psum`);
  * `halos(x, group)`: each rank's neighbours' boundary frames, the
    counterpart of the two `ppermute`s of
    `dvdgan_tpu/parallel/time_shard.py:_halo_exchange`. Its backward sends
    each halo's cotangent back to the rank whose frame it was.

The halos travel as one `all_gather` of every rank's two end frames
(first and last) within the group, not as `send`/`recv`: gloo's
point-to-point ops take CPU tensors only, and a collective keeps every
rank issuing the same calls in the same order. At two time ranks it moves
the frames a pair of `send`s would.

A group of one rank (or `None`) makes every function here the identity,
with no call issued, so a one-process run keeps its bits.

`mean_tree(tree, groups)` is the gradient mean: every leaf of the tree is
copied into one flat buffer per dtype, in the tree's own leaf order (the
same on every rank), reduced once per group and split back. The flagship's
models have hundreds of small leaves, and gloo would pay a host round trip
for each.

`COUNTS` counts the all-reduces and all-gathers issued and the bytes they
carried; it is read around a step, as the kernels' launch counters are.

Under NCCL a CUDA graph can hold every function here (`train/step.py:
MultiStep`): none reads a device value on the host, their buffers (the
clone, the flat buffers, the gathered ends) are allocated inside the call
and so come from the graph's pool, and the halos read only the group's
rank and size. `COUNTS` moves when a call is captured, never when it is
replayed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from dvdgan_tpu_torch.core import tree as tru


@dataclasses.dataclass
class Counts:
    """Collective calls issued by this process, and their payload bytes
    (what one rank contributes)."""
    all_reduce: int = 0
    all_gather: int = 0
    bytes: int = 0

    def snapshot(self) -> dict[str, int]:
        return dataclasses.asdict(self)


COUNTS = Counts()


def size(group) -> int:
    """Ranks in `group` (None: a group of one)."""
    return 1 if group is None else dist.get_world_size(group)


def _active(group) -> bool:
    return size(group) > 1


def _all_reduce(x: torch.Tensor, group, mean: bool) -> torch.Tensor:
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    COUNTS.all_reduce += 1
    COUNTS.bytes += y.numel() * y.element_size()
    if mean:
        y = y / dist.get_world_size(group)
    return y


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        return _all_reduce(x, group, mean)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.mean), None, None


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over the ranks of `group`, with a backward that takes
    the mean of the cotangents the same way."""
    if not _active(group):
        return x
    return _AllReduce.apply(x, group, True)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group`; its backward sums the
    cotangents."""
    if not _active(group):
        return x
    return _AllReduce.apply(x, group, False)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    COUNTS.all_gather += 1
    COUNTS.bytes += x.numel() * x.element_size()
    return out


class _Halos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        i, n = dist.get_rank(group), dist.get_world_size(group)
        ends = _all_gather(torch.stack([x[:, 0], x[:, -1]]), group)
        zero = torch.zeros_like(x[:, 0])
        ctx.group, ctx.shape = group, x.shape
        # rank i−1's last frame comes before mine, rank i+1's first after
        left = ends[i - 1][1] if i > 0 else zero
        right = ends[i + 1][0] if i < n - 1 else zero
        return left, right

    @staticmethod
    def backward(ctx, d_left, d_right):
        group = ctx.group
        i, n = dist.get_rank(group), dist.get_world_size(group)
        back = _all_gather(torch.stack([d_left, d_right]), group)
        dx = d_left.new_zeros(ctx.shape)
        if i > 0:           # my first frame was rank i−1's right halo
            dx[:, 0] += back[i - 1][1]
        if i < n - 1:       # my last frame was rank i+1's left halo
            dx[:, -1] += back[i + 1][0]
        return dx, None


def halos(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T_local, ...) the rank's window of the time axis -> (left,
    right), each (B, ...): the frame before the window (the previous rank's
    last) and the one after it (the next rank's first), zero at the clip's
    two ends."""
    if not _active(group):
        zero = torch.zeros_like(x[:, 0])
        return zero, zero
    return _Halos.apply(x, group)


def mean_tree(tree: Any, groups: Sequence[Optional[object]]) -> Any:
    """The mean of every leaf of `tree` over each group of `groups` in
    turn (no autograd): one flat buffer per dtype, one all-reduce per
    buffer and group. Groups of one rank are skipped; with none left the
    tree comes back as it was."""
    groups = [g for g in groups if _active(g)]
    if not groups:
        return tree

    def reduce(buf: torch.Tensor) -> torch.Tensor:
        for g in groups:
            buf = _all_reduce(buf, g, mean=True)
        return buf

    return map_flat(reduce, tree)


def map_flat(fn, tree: Any) -> Any:
    """`tree` with its leaves replaced by the pieces of fn(buffer), where
    buffer is every leaf of one dtype flattened into one 1-D tensor in the
    tree's leaf order (fn returns a buffer of the same size)."""
    flat = tru.flatten_with_paths(tree)
    out: dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(v.dtype for v in flat.values()):
        keys = [k for k, v in flat.items() if v.dtype == dtype]
        buf = fn(torch.cat([flat[k].detach().reshape(-1) for k in keys]))
        for k, part in zip(keys, buf.split([flat[k].numel() for k in keys])):
            out[k] = part.view(flat[k].shape)
    # rebuilt along the tree itself: a flat {path: u} dict of SN vectors
    # keeps its keys (unflatten would nest them)
    return tru.map_with_path(lambda path, _: out[path], tree)
