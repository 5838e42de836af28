"""Generator G — the counterpart of `dvdgan_tpu/models/generator.py`
(the synthesis variant, cond_frames == 0).

z ∼ N(0, 1) splits into n_levels + 1 chunks; SNLinear(chunk 0) seeds a 4×4
map broadcast over T; each level runs its ConvGRU over the T frames, then a
GResBlock upsampling 2× with time folded into batch, conditioned on
[chunk_{i+1}, embed(y)]; separable attention follows the level that reaches
attn_res; the head is BN → ReLU → SNConv3×3 → tanh (in f32). The internal
layout is time-major (T, B, H, W, C); folded rows are t·B + b.

Parameters, BN running stats and SN `u` vectors are separate trees
(`core/tree.py`); `apply` is a pure function of them. `GeneratorState`
holds the three on one nn.Module for device moves and checkpoints.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.models.config import GConfig
from dvdgan_tpu_torch.ops import attention, convgru, layers, norm, resblocks
from dvdgan_tpu_torch.ops import spectral_norm as sn


def init(gen: torch.Generator, cfg: GConfig) -> tuple[dict, dict]:
    """(params, stats) on the CPU, drawn from `gen`. Orthogonal init
    everywhere, as the reference; the draws differ from jax.random's."""
    if cfg.cond_frames > 0:
        raise NotImplementedError(
            "DVD-GAN-FP (cond_frames > 0) is ROADMAP Queue 1 item 12")
    levels, stats_levels = [], []
    for i in range(cfg.n_levels):
        cin, cout = cfg.level_channels(i)
        levels.append({
            "gru": convgru.convgru_init(gen, cin),
            "block": resblocks.gresblock_init(gen, cin, cout, cfg.cond_dim),
        })
        stats_levels.append(resblocks.gresblock_stats_init(cin, cout))
    c0 = cfg.ch * cfg.mults[0]
    c_last = cfg.ch * cfg.mults[-1]
    params = {
        "embed": layers.embedding_init(gen, cfg.n_classes, cfg.emb_dim),
        "seed": layers.linear_init(gen, cfg.chunk_dim,
                                   cfg.base_res * cfg.base_res * c0),
        "levels": levels,
        "out_bn": norm.bn_init(c_last),
        "out_conv": layers.conv2d_init(gen, 3, c_last, 3),
    }
    if cfg.attn_res is not None and cfg.attn_res <= cfg.img_size:
        c_attn = cfg.ch * cfg.mults[_attn_level_index(cfg) + 1]
        params["attn"] = attention.separable_attn_init(gen, c_attn)
    stats = {"levels": stats_levels, "out_bn": norm.stats_init(c_last)}
    return params, stats


def _attn_level_index(cfg: GConfig) -> int:
    """Index of the upsampling level whose OUTPUT resolution == attn_res."""
    res = cfg.base_res
    for i in range(cfg.n_levels):
        res *= 2
        if res == cfg.attn_res:
            return i
    raise ValueError(f"attn_res={cfg.attn_res} not on the resolution path")


def apply(params: dict, stats: dict, z: torch.Tensor, y: torch.Tensor,
          cfg: GConfig, train: bool, time_major_out: bool = False
          ) -> tuple[torch.Tensor, dict]:
    """G(z, y) -> (video (B, T, H, W, 3) in [-1, 1], new_stats).

    z: (B, z_dim) float, whose dtype is the compute dtype; y: (B,) int class
    ids. time_major_out=True returns the internal (T, B, H, W, 3) layout."""
    if cfg.cond_frames > 0:
        raise NotImplementedError(
            "DVD-GAN-FP (cond_frames > 0) is ROADMAP Queue 1 item 12")
    if cfg.remat and torch.is_grad_enabled():
        # remat changes only what a backward recomputes; forward values
        # are the same with or without it
        raise NotImplementedError(
            "per-level remat lands with the long-clip slice "
            "(ROADMAP Queue 1 item 7)")
    b = z.shape[0]
    t = cfg.n_frames
    n = cfg.n_levels
    dtype = z.dtype

    e = layers.embedding(params["embed"], y).to(dtype)         # (B, emb)
    chunks = torch.split(z, cfg.chunk_dim, dim=-1)

    c0 = cfg.ch * cfg.mults[0]
    x = layers.linear(params["seed"], chunks[0])
    x = x.reshape(b, cfg.base_res, cfg.base_res, c0)
    x_seq = x[None].expand((t,) + x.shape)                     # (T, B, ...)
    attn_idx = _attn_level_index(cfg) if "attn" in params else -1

    new_stats_levels = []
    for i in range(n):
        lvl = params["levels"][i]
        cond = torch.cat([chunks[i + 1], e], dim=-1)           # (B, cond)
        cond_tb = cond.repeat(t, 1)                            # row t·B + b
        # level 0's input is the seed broadcast over time: the GRU input
        # conv runs once and broadcasts
        h_seq = convgru.convgru(lvl["gru"], x_seq, time_major=True,
                                x_static=(i == 0))             # (T,B,H,W,C)
        hw = h_seq.shape[2]
        h = h_seq.reshape(t * b, hw, hw, h_seq.shape[-1])      # fold time
        h, s = resblocks.gresblock(lvl["block"], stats["levels"][i], h,
                                   cond_tb, train=train, upsample=True)
        x_seq = h.reshape(t, b, 2 * hw, 2 * hw, h.shape[-1])
        if i == attn_idx:
            x_seq = attention.separable_attn(params["attn"], x_seq,
                                             time_major=True)
        new_stats_levels.append(s)

    hw = x_seq.shape[2]
    h = x_seq.reshape(t * b, hw, hw, x_seq.shape[-1])
    h, s_out = norm.bn(params["out_bn"], stats["out_bn"], h, train=train)
    h = torch.relu(h)
    h = layers.conv2d(params["out_conv"], h)
    video = torch.tanh(h.float()).to(dtype).reshape(t, b, hw, hw, 3)
    if not time_major_out:
        video = video.movedim(0, 1)
    return video, {"levels": new_stats_levels, "out_bn": s_out}


class GeneratorState(nn.Module):
    """The part of the train state that sampling reads: G's (EMA) params as
    nn.Parameters, its BN running stats and its SN u vectors as buffers,
    each at the attribute path of its reference tree path."""

    def __init__(self, params: dict, stats: dict, sn_u: dict[str, torch.Tensor]):
        super().__init__()
        self.params = tru.to_module(params)
        self.stats = tru.to_module(stats, buffers=True)
        self.sn_u = tru.to_module(tru.unflatten(sn_u), buffers=True)

    @classmethod
    def create(cls, cfg: GConfig, seed: int) -> "GeneratorState":
        """The seeded init, on the CPU (move it with .to(device))."""
        gen = torch.Generator().manual_seed(seed)
        params, stats = init(gen, cfg)
        return cls(params, stats, sn.sn_init(gen, params))

    def trees(self) -> tuple[dict, dict, dict[str, torch.Tensor]]:
        """(params, stats, {path: u}) — the reference's argument trees."""
        return (tru.from_module(self.params),
                tru.from_module(self.stats, buffers=True),
                tru.flatten_with_paths(tru.from_module(self.sn_u,
                                                       buffers=True)))
