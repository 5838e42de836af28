"""The forward kernels that sampling reaches, as registered operators of
the `dvdgan` namespace (`torch.library.custom_op`), so that `torch.export`
can put them into a serving artifact (`dvdgan_tpu_torch/serving.py`): K1
`gru_sequence_fused`, K3 `gru_sequence_blocked`, K5a `ups2x`, K6a
`spatial_attn_fused` and K6b `spatial_attn_tiled`.

A ctypes launch takes raw device addresses, which the fake tensors that
`torch.export` traces with do not have. An op hides it: its CUDA
implementation is the kernel module's own `_forward` (the same
validation, plan, launch and launch counter as an eager call), its CPU
implementation is the module's plain version, and its fake implementation
gives the output's shape and dtype alone (any batch, symbolic or not).
Validation, strides and plans run in the real implementations only.

The kernel entries call these ops only while `torch.compiler.is_exporting()`
is true; every eager call (sampling, training, the autograd Functions, the
CUDA graphs of `train/step.py:MultiStep`) takes the entry's own path as
before. There is no fallback: on a CUDA tensor an op launches its kernel
or raises.

An artifact names the ops, not this module's code: a process that loads
one imports this module first (`serving.load_sampler`), which imports the
kernel modules and nothing of the models.
"""

from typing import Optional

import torch
from torch.library import custom_op

from dvdgan_tpu_torch.kernels import (attention_spatial, convgru_blocked,
                                      convgru_seq, ups2x_fused)

NAMESPACE = "dvdgan"


def _gru_fake(gx, cx, h0, wg, wc):
    return h0.new_empty((gx.shape[0], *h0.shape))


@custom_op("dvdgan::gru_sequence_fused", mutates_args=(),
           device_types="cuda")
def gru_sequence_fused(gx: torch.Tensor, cx: torch.Tensor, h0: torch.Tensor,
                       wg: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """K1: hs (T, B, H, W, C)."""
    return convgru_seq._forward(gx, cx, h0, wg, wc)


gru_sequence_fused.register_kernel("cpu")(convgru_seq.gru_sequence_reference)
gru_sequence_fused.register_fake(_gru_fake)


@custom_op("dvdgan::gru_sequence_blocked", mutates_args=(),
           device_types="cuda")
def gru_sequence_blocked(gx: torch.Tensor, cx: torch.Tensor,
                         h0: torch.Tensor, wg: torch.Tensor,
                         wc: torch.Tensor) -> torch.Tensor:
    """K3: hs (T, B, H, W, C)."""
    return convgru_blocked._forward(gx, cx, h0, wg, wc)


gru_sequence_blocked.register_kernel("cpu")(
    convgru_blocked.gru_sequence_blocked_reference)
gru_sequence_blocked.register_fake(_gru_fake)


@custom_op("dvdgan::ups2x", mutates_args=(), device_types="cuda")
def ups2x(wall: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """K5a: (N, 2H, 2W, Cout) from wall (4·Cin, 4·Cout) and xp
    (N, H+2, W+2, Cin)."""
    return ups2x_fused._forward(wall, xp)


ups2x.register_kernel("cpu")(ups2x_fused.ups2x_reference)


@ups2x.register_fake
def _(wall, xp):
    n, hp2, wp2, _ = xp.shape
    return xp.new_empty((n, 2 * (hp2 - 2), 2 * (wp2 - 2), wall.shape[1] // 4))


@custom_op("dvdgan::spatial_attn_fused", mutates_args=(),
           device_types="cuda")
def spatial_attn_fused(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                       wv: torch.Tensor, wo: torch.Tensor,
                       gamma: torch.Tensor) -> torch.Tensor:
    """K6a: x + γ·attention(x), x's shape and dtype."""
    return attention_spatial._forward(attention_spatial.spatial_attn_fused,
                                      x, wq, wk, wv, wo, gamma)


@spatial_attn_fused.register_kernel("cpu")
def _(x, wq, wk, wv, wo, gamma):
    return attention_spatial.spatial_attn_kernel_reference(x, wq, wk, wv, wo,
                                                           gamma)


@custom_op("dvdgan::spatial_attn_tiled", mutates_args=(),
           device_types="cuda")
def spatial_attn_tiled(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                       wv: torch.Tensor, wo: torch.Tensor, gamma: torch.Tensor,
                       force_bqr: Optional[int] = None) -> torch.Tensor:
    """K6b: the same function through the tiled entry (maps of 64² and
    up)."""
    return attention_spatial._forward(attention_spatial.spatial_attn_tiled,
                                      x, wq, wk, wv, wo, gamma, force_bqr)


@spatial_attn_tiled.register_kernel("cpu")
def _(x, wq, wk, wv, wo, gamma, force_bqr=None):
    attention_spatial._tile_queries(x.shape[1], x.shape[2], force_bqr)
    return attention_spatial.spatial_attn_kernel_reference(x, wq, wk, wv, wo,
                                                           gamma)


def _attn_fake(x, wq, wk, wv, wo, gamma, force_bqr=None):
    return torch.empty_like(x)


spatial_attn_fused.register_fake(_attn_fake)
spatial_attn_tiled.register_fake(_attn_fake)
