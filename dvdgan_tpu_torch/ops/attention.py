"""Separable spatio-temporal self-attention — the counterpart of
`dvdgan_tpu/ops/attention.py` on its default path.

A spatial pass over the H×W grid per frame (keys/values 2×2-max-pooled),
then a temporal pass over T per spatial location ("fold": T moved next to C
and reshaped to (B·H·W, T, C) token batches). Each pass projects q = θ(x):
C→C/8, k = φ(x): C→C/8, v = g(x): C→C/2, out: C/2→C ("pair" mode), with an
f32 softmax and no 1/√d, and adds the result scaled by its own γ.

`fused` is the route of the spatial pass (the reference's `use_pallas`,
carried here by `GConfig.attn_fused`, no environment variable): "off" is
plain PyTorch, as the reference's default is plain XLA; "on" sends it to the
hand-written kernel, through `kernels.spatial_attn_tiled` for maps of 64×64
and up and `kernels.spatial_attn_fused` below: `uses_tiled` chooses the
entry (and so which launch counter counts the call), and the kernel takes
every shape either of the reference's gates (`fits_vmem`, `fits_tiled`)
admits, through either entry. Under "on" an odd H or W raises (the
reference gives way to its XLA path; the port changes no route quietly). The temporal pass is always plain. The
reference's projection mode "fused" and temporal mode "einsum" are TPU A/B
knobs that lost there: no counterpart.
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch import kernels
from dvdgan_tpu_torch.ops import layers

ATTN_FUSED_MODES = ("off", "on")
# maps of at least this many pixels go through the tiled entry (K6b)
TILED_MIN_PIXELS = 64 * 64


def uses_tiled(h: int, w: int) -> bool:
    """True where the fused route takes `spatial_attn_tiled` (K6b)."""
    return h * w >= TILED_MIN_PIXELS


def _proj_init(gen: torch.Generator, c: int) -> dict:
    return {
        "theta": layers.linear_init(gen, c, c // 8, use_bias=False),
        "phi": layers.linear_init(gen, c, c // 8, use_bias=False),
        "g": layers.linear_init(gen, c, c // 2, use_bias=False),
        "out": layers.linear_init(gen, c // 2, c, use_bias=False),
        "gamma": torch.zeros(()),
    }


def separable_attn_init(gen: torch.Generator, c: int) -> dict:
    return {"spatial": _proj_init(gen, c), "temporal": _proj_init(gen, c)}


def _attend(p: dict, x_tokens: torch.Tensor, kv_tokens: torch.Tensor
            ) -> torch.Tensor:
    """Single-head attention. x_tokens: (N, L, C) queries' source;
    kv_tokens: (N, L', C). Returns the γ-scaled delta."""
    dt = x_tokens.dtype
    q = layers.linear(p["theta"], x_tokens)                  # (N, L, C/8)
    k = layers.linear(p["phi"], kv_tokens)                   # (N, L', C/8)
    v = layers.linear(p["g"], kv_tokens)                     # (N, L', C/2)
    logits = torch.bmm(q, k.transpose(1, 2)).float()
    attn = torch.softmax(logits, dim=-1).to(dt)
    o = layers.linear(p["out"], torch.bmm(attn, v))
    return p["gamma"].to(dt) * o


def _maxpool2x_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> (N, H*W/4, C) 2×2 max pool on the underlying grid."""
    n, _, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.amax(dim=(2, 4)).reshape(n, (h // 2) * (w // 2), c)


def spatial_attn(p: dict, x: torch.Tensor, fused: str = "off"
                 ) -> torch.Tensor:
    """The spatial pass on x (..., H, W, C), every leading axis a batch of
    frames: x + γ·attention over the H×W grid, kv 2×2-max-pooled."""
    if fused not in ATTN_FUSED_MODES:
        raise ValueError(f"fused must be one of {ATTN_FUSED_MODES}, got "
                         f"{fused!r}")
    h, w, c = x.shape[-3:]
    pool_ok = h % 2 == 0 and w % 2 == 0
    sp = p["spatial"]
    if fused == "on":
        if not pool_ok:
            raise ValueError(f"attn_fused='on' needs even H and W, got "
                             f"{(h, w)}")
        entry = (kernels.spatial_attn_tiled if uses_tiled(h, w)
                 else kernels.spatial_attn_fused)
        out = entry(x.reshape(-1, h, w, c), sp["theta"]["w"], sp["phi"]["w"],
                    sp["g"]["w"], sp["out"]["w"], sp["gamma"].float())
        return out.reshape(x.shape)
    xs = x.reshape(-1, h * w, c)
    kv = _maxpool2x_tokens(xs, h, w) if pool_ok else xs
    return (xs + _attend(sp, xs, kv)).reshape(x.shape)


def temporal_attn(p: dict, x: torch.Tensor, time_major: bool = False
                  ) -> torch.Tensor:
    """The temporal pass on x (B, T, H, W, C) — (T, B, H, W, C) with
    `time_major` — over T per spatial location."""
    time_src = 0 if time_major else 1
    xt = x.movedim(time_src, 3)                  # (B, H, W, T, C)
    tm_shape = xt.shape
    xt = xt.reshape(-1, *tm_shape[3:])
    xt = xt + _attend(p["temporal"], xt, xt)
    return xt.reshape(tm_shape).movedim(3, time_src)


def separable_attn(p: dict, x: torch.Tensor, fused: str = "off",
                   time_major: bool = False) -> torch.Tensor:
    """x: (B, T, H, W, C) — or (T, B, H, W, C) with `time_major=True` —
    -> same layout; spatial pass then temporal pass."""
    return temporal_attn(p, spatial_attn(p, x, fused), time_major)
