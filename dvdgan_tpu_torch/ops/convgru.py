"""Convolutional GRU — the counterpart of `dvdgan_tpu/ops/convgru.py`.

    rz = σ(Conv3×3_x(x) + Conv3×3_h(h))
    c  = tanh(Conv3×3_x'(x) + Conv3×3_h'(r ⊙ h))
    h' = (1 − z) ⊙ h + z ⊙ c

As on the reference, the input halves (`gates_x`, `cand_x`) are hoisted out
of the recurrence into ONE C→3C conv over the folded (T·B) batch (a plain
`F.conv2d`: the reference computes it outside any Pallas kernel too), and the
hidden-dependent halves run in the whole-sequence kernel K1
(`kernels.gru_sequence_fused`). The initial hidden state is zero.
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch import kernels
from dvdgan_tpu_torch.ops import layers


def convgru_init(gen: torch.Generator, c: int, k: int = 3) -> dict:
    return {
        "gates_x": layers.conv2d_init(gen, k, c, 2 * c),
        "gates_h": layers.conv2d_init(gen, k, c, 2 * c, use_bias=False),
        "cand_x": layers.conv2d_init(gen, k, c, c),
        "cand_h": layers.conv2d_init(gen, k, c, c, use_bias=False),
    }


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

    wcat = torch.cat([p["gates_x"]["w"], p["cand_x"]["w"]], dim=-1)
    bcat = torch.cat([p["gates_x"]["b"], p["cand_x"]["b"]])
    if x_static:
        x0 = x_seq[0] if time_major else x_seq[:, 0]
        gcx0 = layers.conv2d({"w": wcat, "b": bcat}, x0)   # (B, H, W, 3C)
        gx = gcx0[None, ..., :2 * c].expand(t, b, h, w, 2 * c)
        cx = gcx0[None, ..., 2 * c:].expand(t, b, h, w, c)
    else:
        xf = x_seq.reshape(b * t, h, w, c)   # fold order matches layout
        gcx = layers.conv2d({"w": wcat, "b": bcat}, xf)
        gx, cx = gcx[..., :2 * c], gcx[..., 2 * c:]
        if time_major:
            gx = gx.reshape(t, b, h, w, 2 * c)
            cx = cx.reshape(t, b, h, w, c)
        else:
            gx = gx.reshape(b, t, h, w, 2 * c).movedim(1, 0)
            cx = cx.reshape(b, t, h, w, c).movedim(1, 0)

    wg = p["gates_h"]["w"].to(x_seq.dtype).contiguous()
    wc = p["cand_h"]["w"].to(x_seq.dtype).contiguous()
    hs = kernels.gru_sequence_fused(gx, cx, h0, wg, wc)
    return hs if time_major else hs.movedim(0, 1)
