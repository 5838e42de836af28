"""Generator G — the counterpart of `dvdgan_tpu/models/generator.py`.

z ∼ N(0, 1) splits into n_levels + 1 chunks; SNLinear(chunk 0) seeds a 4×4
map broadcast over T; each level runs its ConvGRU over the T frames, then a
GResBlock upsampling 2× with time folded into batch, conditioned on
[chunk_{i+1}, embed(y)]; separable attention follows the level that reaches
attn_res; the head is BN → ReLU → SNConv3×3 → tanh (in f32). The internal
layout is time-major (T, B, H, W, C); folded rows are t·B + b.

DVD-GAN-FP (`cfg.cond_frames > 0`, video prediction): `apply` takes the
real prefix `cond_video` (B, cond_frames, H, W, 3). A strided-conv frame
encoder (`params["fp_enc"]`) gives each level a feature sequence of the
level's GRU width; the level's own GRU runs over it first (the warm-up), and
its last hidden state is the h0 of the generation scan. The output is the
n_frames generated frames only.

Parameters, BN running stats and SN `u` vectors are separate trees
(`core/tree.py`); `apply` is a pure function of them. `GeneratorState`
holds the three on one nn.Module for device moves and checkpoints.

`cfg.remat` (the long-clip presets) rematerializes each level under a
backward. `cfg.remat_save` is the policy (the reference's `_remat_save`;
`_level` has each one's regions): the default "gru+ups" keeps a level's
GRU hidden sequence (the sequence kernels never rerun) and its upsample
conv's output, and recomputes the rest of its GResBlock, and the attention
after it, when the backward reaches the level; "gru", "ups" and "none"
keep less and recompute more, the GRU's kernels included under "ups" and
"none". Remat changes what is recomputed, never a value: outputs,
gradients and BN statistics (taken from the first forward) are those of
the plain forward under every policy. Unlike the reference, the GRU's
hoisted input conv is kept as well where the GRU runs outside the regions
(the sequence Function saves its gx and cx).

`cfg.ups_fused` is the route of every level's upsample conv
(`ops/layers.py:upsample2x_conv3x3`; the reference reads it from the
environment, `_ups_pallas`). With the fused route ("fwd", "full") and
remat under "gru+ups", the fused conv runs outside both checkpoint
regions, as the GRU does: its kernel launches once per level and
forward, never from a backward, and its Function keeps its padded input
(which the "off" route recomputes); the CBN → ReLU before it is a region
of its own. Under the other policies it runs inside a region and launches
again from the backward. The FP
encoder and the warm-up GRU run outside the regions as well: the warm-up's
kernel launches once per forward, and its backward kernel once per
backward.

`cfg.attn_fused` is the route of the attention's spatial pass
(`ops/attention.py`; the reference reads it from the environment,
`_pallas_default`). With "on" and remat the fused pass runs outside the
checkpoint regions under every policy: the last region ends before it, its
kernel launches once per forward and never from a backward (its Function
keeps only its input, which is the last region's output, and five small
tensors), and the temporal pass after it is a region of its own.

Cross-replica BN (`group`, a process group of the data ranks; the
reference's `axis_name`): every CBN and the head's BN average their batch
moments over the group (`ops/norm.py`), each a collective that all ranks
must issue in the same order. Under remat the CBNs sit inside the
checkpoint regions, and the policy keeps only the upsample conv's output,
so a backward that replays a region issues that region's all-reduces
again. The port keeps that recompute rather than saving the moments:
every rank runs the same program on the same shapes, so every rank
replays the same regions in the same order (autograd's order for one
graph), and a replay issues the same all-reduces as the forward did, on
inputs that give the same moments. A test counts each rank's all-reduces
over a step under remat and holds the step to the one without remat.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.models.config import GConfig
from dvdgan_tpu_torch.ops import attention, convgru, layers, norm, resblocks
from dvdgan_tpu_torch.ops import spectral_norm as sn
from dvdgan_tpu_torch.utils.profiling import span


def init(gen: torch.Generator, cfg: GConfig) -> tuple[dict, dict]:
    """(params, stats) on the CPU, drawn from `gen`. Orthogonal init
    everywhere, as the reference; the draws differ from jax.random's."""
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
    if cfg.cond_frames > 0:
        params["fp_enc"] = _fp_encoder_init(gen, cfg)
    stats = {"levels": stats_levels, "out_bn": norm.stats_init(c_last)}
    return params, stats


def _fp_encoder_init(gen: torch.Generator, cfg: GConfig) -> dict:
    """The DVD-GAN-FP frame encoder: a stride-1 3→ch·mults[n−1] stem, then
    n stride-2 stages from img_size down to base_res; the stage that lands
    at base_res·2^i emits ch·mults[i] channels, level i's GRU width. Its
    kernels are `w` leaves, so the SN pass normalizes them."""
    n = cfg.n_levels
    cin = cfg.ch * cfg.mults[n - 1]
    stages = [layers.conv2d_init(gen, 3, 3, cin)]
    for i in range(n - 1, -1, -1):
        cout = cfg.ch * cfg.mults[i]
        stages.append(layers.conv2d_init(gen, 3, cin, cout))
        cin = cout
    return {"stages": stages}


def _fp_encode(params: dict, cond: torch.Tensor, cfg: GConfig
               ) -> list[torch.Tensor]:
    """cond (B, C, H, W, 3) -> level i's time-major features (C, B,
    base_res·2^i, base_res·2^i, ch·mults[i]) for i in 0 … n_levels − 1,
    each conv followed by a ReLU."""
    b, c = cond.shape[:2]
    n = cfg.n_levels
    stages = params["fp_enc"]["stages"]
    x = cond.reshape(b * c, *cond.shape[2:])
    x = torch.relu(layers.conv2d(stages[0], x))
    taps = [None] * n
    for j, i in enumerate(range(n - 1, -1, -1)):
        x = torch.relu(layers.conv2d(stages[j + 1], x, stride=2))
        taps[i] = x
    return [t.reshape(b, c, *t.shape[1:]).movedim(1, 0) for t in taps]


def _attn_level_index(cfg: GConfig) -> int:
    """Index of the upsampling level whose OUTPUT resolution == attn_res."""
    res = cfg.base_res
    for i in range(cfg.n_levels):
        res *= 2
        if res == cfg.attn_res:
            return i
    raise ValueError(f"attn_res={cfg.attn_res} not on the resolution path")


def _save_ups_conv(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy that keeps the upsample conv's output
    (the unfused route's phase conv: G's one conv with a 2×2 kernel) and
    recomputes everything else."""
    if (op is torch.ops.aten.convolution.default
            and tuple(args[1].shape[-2:]) == (2, 2)):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _level(lvl: dict, lvl_stats: dict, x_seq: torch.Tensor,
           h0: torch.Tensor | None, cond_tb: torch.Tensor, level0: bool,
           attn: dict | None, train: bool, remat: bool, cfg: GConfig,
           group=None):
    """One level: its GRU over the T frames of x_seq (T, B, H, W, C), the
    upsampling GResBlock on the folded (T·B, H, W, C) sequence, then
    attention where `attn` is given. -> (x_seq (T, B, 2H, 2W, C'), block
    stats).

    With `remat`, `cfg.remat_save` decides what the level keeps for the
    backward (the reference's `_remat_save`, whose regions are the whole
    level under a save-these-names policy):
      "gru+ups": the GRU runs outside the regions (its hidden sequence is
        kept), and two regions split at the upsample conv's output, which
        the first keeps (route "off") or which the fused conv, run between
        the two, keeps in its Function;
      "gru": the GRU outside, the block one plain region: the upsample
        conv is recomputed;
      "ups": the GRU inside one region with the whole block, which keeps
        the upsample conv's output (route "off");
      "none": the whole level one plain region.
    The sequence kernels (K1, K3) and the fused upsample conv (K5a) are
    ctypes launches inside autograd Functions, which no policy can keep:
    inside a region they run again when the backward reaches it. So under
    "ups" and "none" the GRU's kernel launches twice per level and
    forward, and under "gru", "ups" and "none" a fused conv runs inside the
    region and launches twice too (kept outside, it would keep its output
    and the policy would be "gru+ups"'s). A fused spatial attention pass
    stays outside the regions under every policy (its Function keeps only
    its input, the region's output, and five small tensors); the temporal
    pass after it is a region of its own."""
    t, b = x_seq.shape[:2]
    p = lvl["block"]
    ups_fused, attn_fused = cfg.ups_fused, cfg.attn_fused
    # under remat a fused spatial pass leaves the regions
    split_attn = remat and attn is not None and attn_fused != "off"

    def gru(x_seq):
        h_seq = convgru.convgru(lvl["gru"], x_seq, h0=h0, time_major=True,
                                x_static=level0)              # (T,B,H,W,C)
        return h_seq.reshape(t * b, *h_seq.shape[2:])         # fold time

    def pre(h):
        return resblocks.gresblock_pre(p, lvl_stats, h, cond_tb, train,
                                       group)

    def head(h):
        return resblocks.gresblock_head(p, lvl_stats, h, cond_tb, train,
                                        upsample=True, ups_fused=ups_fused,
                                        group=group)

    def tail(u, h):
        out, s2 = resblocks.gresblock_tail(p, lvl_stats, u, h, cond_tb, train,
                                           upsample=True, group=group)
        x_seq = out.reshape(t, b, *out.shape[1:])
        if attn is not None and not split_attn:
            x_seq = attention.separable_attn(attn, x_seq, attn_fused,
                                             time_major=True)
        return x_seq, s2

    def block(h):
        u, s1 = head(h)
        x_seq, s2 = tail(u, h)
        return x_seq, s1, s2

    def level(x_seq):
        return block(gru(x_seq))

    if not remat:
        x_seq, s1, s2 = level(x_seq)
        return x_seq, {"bn1": s1, "bn2": s2}
    # nothing in a level draws random numbers
    run = functools.partial(ckpt.checkpoint, use_reentrant=False,
                            preserve_rng_state=False)
    keep_ups = functools.partial(run, context_fn=functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_ups_conv))
    save = cfg.remat_save
    if save == "gru+ups":
        h = gru(x_seq)
        if ups_fused == "off":
            u, s1 = keep_ups(head, h)
        else:
            a, s1 = run(pre, h)
            u = resblocks.gresblock_conv1(p, a, upsample=True,
                                          ups_fused=ups_fused)
        x_seq, s2 = run(tail, u, h)
    elif save == "gru":
        x_seq, s1, s2 = run(block, gru(x_seq))
    elif save == "ups":
        x_seq, s1, s2 = keep_ups(level, x_seq)
    else:
        x_seq, s1, s2 = run(level, x_seq)
    if split_attn:
        x_seq = attention.spatial_attn(attn, x_seq, attn_fused)
        x_seq = run(attention.temporal_attn, attn, x_seq, time_major=True)
    return x_seq, {"bn1": s1, "bn2": s2}


def apply(params: dict, stats: dict, z: torch.Tensor, y: torch.Tensor,
          cfg: GConfig, train: bool, cond_video: torch.Tensor | None = None,
          time_major_out: bool = False, group=None
          ) -> tuple[torch.Tensor, dict]:
    """G(z, y[, cond_video]) -> (video (B, T, H, W, 3) in [-1, 1],
    new_stats).

    z: (B, z_dim) float, whose dtype is the compute dtype; y: (B,) int class
    ids; with cfg.cond_frames > 0, cond_video is the real prefix (B,
    cond_frames, H, W, 3), cast to the compute dtype, and the video is the
    n_frames generated after it. time_major_out=True returns the internal
    (T, B, H, W, 3) layout. `group`: the data ranks' process group of
    cross-replica BN (train mode only; None: this process's batch). Each
    level is the span "g.<i>" and the output head "g.head"
    (`utils/profiling.py:span`)."""
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
    # remat only matters where a backward will follow
    remat = cfg.remat and torch.is_grad_enabled()
    enc_seqs = [None] * n
    if cfg.cond_frames > 0:
        if cond_video is None:
            raise ValueError("cond_frames > 0 requires cond_video")
        enc_seqs = _fp_encode(params, cond_video.to(dtype), cfg)

    new_stats_levels = []
    for i in range(n):
        lvl = params["levels"][i]
        cond = torch.cat([chunks[i + 1], e], dim=-1)           # (B, cond)
        cond_tb = cond.repeat(t, 1)                            # row t·B + b
        with span(f"g.{i}"):
            h0 = None
            if enc_seqs[i] is not None:
                # FP warm-up: the level's GRU over the encoded prefix; its
                # last hidden state seeds the generation
                h0 = convgru.convgru(lvl["gru"], enc_seqs[i],
                                     time_major=True)[-1]
            # level 0's input is the seed broadcast over time: the GRU
            # input conv runs once and broadcasts
            x_seq, s = _level(lvl, stats["levels"][i], x_seq, h0, cond_tb,
                              i == 0,
                              params["attn"] if i == attn_idx else None,
                              train, remat, cfg, group)
        new_stats_levels.append(s)

    with span("g.head"):
        hw = x_seq.shape[2]
        h = x_seq.reshape(t * b, hw, hw, x_seq.shape[-1])
        h, s_out = norm.bn(params["out_bn"], stats["out_bn"], h, train=train,
                           group=group)
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
