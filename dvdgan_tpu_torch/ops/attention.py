"""Separable spatio-temporal self-attention — the counterpart of
`dvdgan_tpu/ops/attention.py` on its default path.

A spatial pass over the H×W grid per frame (keys/values 2×2-max-pooled),
then a temporal pass over T per spatial location ("fold": T moved next to C
and reshaped to (B·H·W, T, C) token batches). Each pass projects q = θ(x):
C→C/8, k = φ(x): C→C/8, v = g(x): C→C/2, out: C/2→C ("pair" mode), with an
f32 softmax and no 1/√d, and adds the result scaled by its own γ.

The reference's fused Pallas spatial kernels (K6) are off on that path; this
is plain PyTorch, as the reference's is plain XLA.
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch.ops import layers


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


def separable_attn(p: dict, x: torch.Tensor, time_major: bool = False
                   ) -> torch.Tensor:
    """x: (B, T, H, W, C) — or (T, B, H, W, C) with `time_major=True` —
    -> same layout; spatial pass then temporal pass."""
    if time_major:
        t, b, h, w, c = x.shape
    else:
        b, t, h, w, c = x.shape
    n = b * t
    pool_ok = h % 2 == 0 and w % 2 == 0

    xs = x.reshape(n, h * w, c)
    kv = _maxpool2x_tokens(xs, h, w) if pool_ok else xs
    xs = xs + _attend(p["spatial"], xs, kv)
    x = xs.reshape(x.shape)

    time_src = 0 if time_major else 1
    xt = x.movedim(time_src, 3)                  # (B, H, W, T, C)
    tm_shape = xt.shape
    xt = xt.reshape(b * h * w, t, c)
    xt = xt + _attend(p["temporal"], xt, xt)
    return xt.reshape(tm_shape).movedim(3, time_src)
