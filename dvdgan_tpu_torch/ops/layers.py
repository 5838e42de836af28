"""Primitive layers — the counterpart of `dvdgan_tpu/ops/layers.py`.

Pure functions over explicit param dicts with the reference's conventions:
activations channels-last (N, H, W, C); conv kernels HWIO, linears (in, out).
The compute dtype follows the activation dtype; a bias is added after the
conv's output is rounded to it, as on the reference. `conv2d` reorders to
PyTorch's NCHW/OIHW views at the `F.conv2d` call only: an NHWC-contiguous
tensor seen as NCHW is channels_last, so no copy is made.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dvdgan_tpu_torch.core import init as winit

Params = dict


# ---------------------------------------------------------------- linear ----

def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                use_bias: bool = True) -> Params:
    p = {"w": winit.orthogonal(gen, (in_dim, out_dim))}
    if use_bias:
        p["b"] = winit.zeros((out_dim,))
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------- conv2d ----

def conv2d_init(gen: torch.Generator, k: int, cin: int, cout: int,
                use_bias: bool = True) -> Params:
    p = {"w": winit.orthogonal(gen, (k, k, cin, cout))}
    if use_bias:
        p["b"] = winit.zeros((cout,))
    return p


def conv2d(p: Params, x: torch.Tensor, padding: str = "SAME") -> torch.Tensor:
    """Stride-1 conv. x: (N, H, W, C) -> (N, H', W', C_out), contiguous."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[:2]
    if padding == "SAME":
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"SAME padding needs an odd kernel, got {kh}×{kw}")
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=pad)
    y = y.permute(0, 2, 3, 1).contiguous()
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def upsample2x_conv3x3(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Nearest-upsample-2× then a SAME 3×3 conv, computed as ONE 2×2-kernel
    VALID conv with 4 output phases and an interleave (the reference's
    phase decomposition). Per output phase the 3 taps of each dimension
    collapse to 2 source taps whose kernels are sums of the original taps:
    rows p=0: [w0, w1+w2], rows p=1: [w0+w1, w2] (the same per column).
    The sums are formed in the weights' own dtype (the compute dtype after
    `sn_normalize`), so in bf16 they round as the reference's do."""
    w = p["w"]                                        # (3, 3, Cin, Cout)
    cout = w.shape[-1]
    r0 = torch.stack([w[0], w[1] + w[2]])             # (2, 3, Cin, Cout)
    r1 = torch.stack([w[0] + w[1], w[2]])

    def cols(r):
        return (torch.stack([r[:, 0], r[:, 1] + r[:, 2]], dim=1),
                torch.stack([r[:, 0] + r[:, 1], r[:, 2]], dim=1))

    w00, w01 = cols(r0)
    w10, w11 = cols(r1)                               # each (2, 2, Cin, Cout)
    wall = torch.cat([w00, w01, w10, w11], dim=-1)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    y = conv2d({"w": wall}, xp, padding="VALID")      # (N, H+1, W+1, 4Cout)
    n, hp1, wp1, _ = y.shape
    h, wd = hp1 - 1, wp1 - 1
    y00 = y[:, :h, :wd, 0 * cout:1 * cout]
    y01 = y[:, :h, 1:, 1 * cout:2 * cout]
    y10 = y[:, 1:, :wd, 2 * cout:3 * cout]
    y11 = y[:, 1:, 1:, 3 * cout:4 * cout]
    top = torch.stack([y00, y01], dim=3)              # (N, H, W, 2, Cout)
    bot = torch.stack([y10, y11], dim=3)
    out = torch.stack([top, bot], dim=2).reshape(n, 2 * h, 2 * wd, cout)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


# ------------------------------------------------------------- embedding ----

def embedding_init(gen: torch.Generator, n: int, dim: int) -> Params:
    # leaf name 'emb' opts into the SN pass (ops/spectral_norm.py)
    return {"emb": winit.orthogonal(gen, (n, dim))}


def embedding(p: Params, idx: torch.Tensor) -> torch.Tensor:
    """idx: int tensor (...,) -> (..., dim)."""
    return p["emb"][idx]
