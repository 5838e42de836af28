"""Convolutional GRU — the counterpart of `dvdgan_tpu/ops/convgru.py`.

    rz = σ(Conv3×3_x(x) + Conv3×3_h(h))
    c  = tanh(Conv3×3_x'(x) + Conv3×3_h'(r ⊙ h))
    h' = (1 − z) ⊙ h + z ⊙ c

As on the reference, the input halves (`gates_x`, `cand_x`) are hoisted out
of the recurrence into ONE C→3C conv over the folded (T·B) batch (a plain
`F.conv2d`: the reference computes it outside any Pallas kernel too), and the
hidden-dependent halves run in a whole-sequence kernel: K1
(`kernels.gru_sequence_fused`) for small planes, K3
(`kernels.gru_sequence_blocked`) for large ones (`uses_blocked`). The
initial hidden state is zero.

`convgru_cell` is the single-step entry (the reference's `convgru_cell`,
`dvdgan_tpu/ops/convgru.py:58`): the input convs as a plain conv (the same
C→3C conv, so that T calls of it give the hidden sequence `convgru` gives)
and the hidden-dependent part in K4 (`kernels.gru_cell_fused`).
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch import kernels
from dvdgan_tpu_torch.ops import layers


# The K1/K3 choice is a function of the plane's shape alone, at every T and
# in both dtypes: K3 takes planes of at least K3_MIN_PIXELS pixels, K1 the
# rest. The reference splits at 65 536 elements per sample (its whole-plane
# kernel holds 16²×256 and 32²×64 and nothing larger), which also sends the
# 32²-pixel planes of the large presets (32²×256 at 256 px, 32²×128 at
# 128 px) to its blocked kernel; here they stay with K1. That line was drawn
# on H100 measurements (PERF.md §6): K3 gives a launch one CTA per 8×8 tile
# and sample, 32 CTAs for a 32² plane at batch 2 on 132 SMs, and ran 5×
# slower than K1 there. In every preset a plane of 64² pixels or more is
# over the reference's 65 536 elements, so K3 takes no plane that the
# reference gives K1, and it takes the 128²×64 plane that the reference
# could only scan.
K3_MIN_PIXELS = 64 * 64


def uses_blocked(h: int, w: int) -> bool:
    """True where a plane of h × w pixels goes to K3 instead of K1."""
    return h * w >= K3_MIN_PIXELS


def convgru_init(gen: torch.Generator, c: int, k: int = 3) -> dict:
    return {
        "gates_x": layers.conv2d_init(gen, k, c, 2 * c),
        "gates_h": layers.conv2d_init(gen, k, c, 2 * c, use_bias=False),
        "cand_x": layers.conv2d_init(gen, k, c, c),
        "cand_h": layers.conv2d_init(gen, k, c, c, use_bias=False),
    }


def _input_conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The gate and candidate input convs as ONE C→3C conv (each output
    channel's dot product is that of the separate convs).
    x: (N, H, W, C) -> (N, H, W, 3C): gx = [..., :2C], cx = [..., 2C:]."""
    wcat = torch.cat([p["gates_x"]["w"], p["cand_x"]["w"]], dim=-1)
    bcat = torch.cat([p["gates_x"]["b"], p["cand_x"]["b"]])
    return layers.conv2d({"w": wcat, "b": bcat}, x)


def convgru_cell(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step from raw x. x, h: (B, H, W, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    gcx = _input_conv(p, x)
    wg = p["gates_h"]["w"].to(x.dtype).contiguous()
    wc = p["cand_h"]["w"].to(x.dtype).contiguous()
    return kernels.gru_cell_fused(gcx[..., :2 * c], gcx[..., 2 * c:],
                                  h.contiguous(), wg, wc)


def convgru(p: dict, x_seq: torch.Tensor, h0: torch.Tensor | None = None,
            time_major: bool = False, x_static: bool = False) -> torch.Tensor:
    """Unroll over time. x_seq: (B, T, H, W, C) — or (T, B, H, W, C) with
    `time_major=True` — -> hidden sequence, same layout.

    `x_static=True` asserts all T input frames are identical (the
    generator's level-0 input is the latent seed broadcast over time): the
    input conv then runs once and its output is broadcast over T as a
    stride-0 view, which the kernel reads as such."""
    if time_major:
        t, b, h, w, c = x_seq.shape
    else:
        b, t, h, w, c = x_seq.shape
    if h0 is None:
        h0 = torch.zeros((b, h, w, c), dtype=x_seq.dtype, device=x_seq.device)

    if x_static:
        x0 = x_seq[0] if time_major else x_seq[:, 0]
        gcx0 = _input_conv(p, x0)                          # (B, H, W, 3C)
        gx = gcx0[None, ..., :2 * c].expand(t, b, h, w, 2 * c)
        cx = gcx0[None, ..., 2 * c:].expand(t, b, h, w, c)
    else:
        xf = x_seq.reshape(b * t, h, w, c)   # fold order matches layout
        gcx = _input_conv(p, xf)
        gx, cx = gcx[..., :2 * c], gcx[..., 2 * c:]
        if time_major:
            gx = gx.reshape(t, b, h, w, 2 * c)
            cx = cx.reshape(t, b, h, w, c)
        else:
            gx = gx.reshape(b, t, h, w, 2 * c).movedim(1, 0)
            cx = cx.reshape(b, t, h, w, c).movedim(1, 0)

    wg = p["gates_h"]["w"].to(x_seq.dtype).contiguous()
    wc = p["cand_h"]["w"].to(x_seq.dtype).contiguous()
    if uses_blocked(h, w):
        hs = kernels.gru_sequence_blocked(gx, cx, h0, wg, wc)
    else:
        hs = kernels.gru_sequence_fused(gx, cx, h0, wg, wc)
    return hs if time_major else hs.movedim(0, 1)
