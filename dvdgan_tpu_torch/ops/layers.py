"""Primitive layers — the counterpart of `dvdgan_tpu/ops/layers.py`.

Pure functions over explicit param dicts with the reference's conventions:
activations channels-last (N, H, W, C) and (N, T, H, W, C); conv kernels
HWIO and DHWIO, linears (in, out). The compute dtype follows the activation
dtype; a bias is added after the conv's output is rounded to it, as on the
reference. `conv2d`/`conv3d` reorder to PyTorch's NCHW/OIHW (NCDHW/OIDHW)
views at the `F.conv2d`/`F.conv3d` call only: a channels-last-contiguous
tensor seen that way is channels_last, so no copy is made.

`upsample2x_conv3x3(p, x, fused)` carries the reference's choice of route
for the upsample conv (`dvdgan_tpu/ops/layers.py:_ups_pallas`, there the
environment variable DVDGAN_UPS_PALLAS) as an argument: "off" is the phase
conv (cuDNN) and a stack interleave, "fwd" and "full" go through the fused
kernel `kernels.ups2x_fused.ups2x` (K5a; "full" with K5b as its backward).

The reference's TPU lowerings of the same convs (the stem conv's im2col
weight-grad, the row-pair and temporal-pair/phase 3-D forms, `grad_barrier`)
compute the same function and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dvdgan_tpu_torch.core import init as winit
from dvdgan_tpu_torch.kernels import ups2x_fused

Params = dict
UPS_FUSED_MODES = ("off", "fwd", "full")


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


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one dimension, (before, after): the output
    has ceil(size / stride) positions, and an odd total goes after (a
    stride-2 3×3 conv over an even size pads (0, 1), not (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, window, stride, dims, value: float = 0.0
             ) -> tuple[torch.Tensor, tuple[int, ...]]:
    """XLA's SAME padding of x's `dims` for `window` at `stride` (one
    entry per dim), split as a conv or pool takes it: (x, pad), where pad
    is the op's own symmetric padding if every dim pads symmetrically,
    else x padded with `value` (an odd total's extra element after) and
    pad all 0."""
    pads = [same_padding(x.shape[d], k, s)
            for d, k, s in zip(dims, window, stride)]
    if all(a == b for a, b in pads):
        return x, tuple(a for a, _ in pads)
    by_dim = dict(zip(dims, pads))
    flat = [q for d in range(x.dim() - 1, min(dims) - 1, -1)
            for q in by_dim.get(d, (0, 0))]      # F.pad: last dim first
    return F.pad(x, flat, value=value), (0,) * len(pads)


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x: (N, H, W, C) -> (N, H', W', C_out), contiguous. SAME pads as XLA
    does (`pad_same`): symmetric padding goes to the conv, other padding
    is applied first and the conv is VALID."""
    w = p["w"].to(x.dtype)
    if padding == "SAME":
        x, pad = pad_same(x, w.shape[:2], (stride, stride), (1, 2))
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                 padding=pad)
    y = y.permute(0, 2, 3, 1).contiguous()
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def upsample2x_conv3x3(p: Params, x: torch.Tensor, fused: str = "off"
                       ) -> torch.Tensor:
    """Nearest-upsample-2× then a SAME 3×3 conv, computed as ONE 2×2-kernel
    VALID conv with 4 output phases and an interleave (the reference's
    phase decomposition). Per output phase the 3 taps of each dimension
    collapse to 2 source taps whose kernels are sums of the original taps:
    rows p=0: [w0, w1+w2], rows p=1: [w0+w1, w2] (the same per column).
    The sums are formed in the weights' own dtype (the compute dtype after
    `sn_normalize`), so in bf16 they round as the reference's do, and
    outside any kernel, so that d(wall) → d(w) is plain autograd.

    `fused`: "off" runs the phase conv and interleaves its four slices;
    "fwd" and "full" run both in the fused kernel (`ups2x_fused.ups2x`),
    whose backward is its own kernel under "full" and the plain version,
    recomputed, under "fwd". The bias is added after the rounded output
    either way."""
    if fused not in UPS_FUSED_MODES:
        raise ValueError(f"fused must be one of {UPS_FUSED_MODES}, got "
                         f"{fused!r}")
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
    if fused == "off":
        out = phase_conv_interleave(wall, xp)
    else:
        cin = x.shape[-1]
        out = ups2x_fused.ups2x(
            wall.to(x.dtype).reshape(4 * cin, 4 * cout), xp, fused == "full")
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def phase_conv_interleave(wall: torch.Tensor, xp: torch.Tensor
                          ) -> torch.Tensor:
    """The unfused route of `upsample2x_conv3x3`: one VALID conv with the
    four phase kernels wall (2, 2, Cin, 4·Cout) over the padded input xp
    (N, H+2, W+2, Cin), then the interleave of its four phase slices.
    -> (N, 2H, 2W, Cout)."""
    cout = wall.shape[-1] // 4
    y = conv2d({"w": wall}, xp, padding="VALID")      # (N, H+1, W+1, 4Cout)
    n, hp1, wp1, _ = y.shape
    h, wd = hp1 - 1, wp1 - 1
    y00 = y[:, :h, :wd, 0 * cout:1 * cout]
    y01 = y[:, :h, 1:, 1 * cout:2 * cout]
    y10 = y[:, 1:, :wd, 2 * cout:3 * cout]
    y11 = y[:, 1:, 1:, 3 * cout:4 * cout]
    top = torch.stack([y00, y01], dim=3)              # (N, H, W, 2, Cout)
    bot = torch.stack([y10, y11], dim=3)
    return torch.stack([top, bot], dim=2).reshape(n, 2 * h, 2 * wd, cout)


# ---------------------------------------------------------------- conv3d ----

def conv3d_init(gen: torch.Generator, k: tuple[int, int, int], cin: int,
                cout: int, use_bias: bool = True) -> Params:
    kt, kh, kw = k
    p = {"w": winit.orthogonal(gen, (kt, kh, kw, cin, cout))}
    if use_bias:
        p["b"] = winit.zeros((cout,))
    return p


def conv3d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv. x: (N, T, H, W, C) -> (N, T, H, W, C_out),
    contiguous; the kernel is DHWIO (odd in every dimension)."""
    w = p["w"].to(x.dtype)
    if any(k % 2 == 0 for k in w.shape[:3]):
        raise ValueError(f"SAME padding needs an odd kernel, got "
                         f"{tuple(w.shape[:3])}")
    pad = tuple(k // 2 for k in w.shape[:3])
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=pad)
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ------------------------------------------------------------- embedding ----

def embedding_init(gen: torch.Generator, n: int, dim: int) -> Params:
    # leaf name 'emb' opts into the SN pass (ops/spectral_norm.py)
    return {"emb": winit.orthogonal(gen, (n, dim))}


def embedding(p: Params, idx: torch.Tensor) -> torch.Tensor:
    """idx: int tensor (...,) -> (..., dim)."""
    return p["emb"][idx]
