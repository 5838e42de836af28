"""Single ConvGRU step, K4 — the counterpart of
`dvdgan_tpu/kernels/convgru_cell.py:gru_cell_fused`.

gx (B, H, W, 2C), cx (B, H, W, C), h (B, H, W, C), wg (3, 3, C, 2C),
wc (3, 3, C, C) -> h' (B, H, W, C): one step of K1's recurrence, with the
TPU kernel body's rounding points (`kernel_gru_step`: gh and gx summed in
f32, r⊙h rounded to the activation dtype before the candidate conv, the
blend in f32 rounded once). So its plain version `gru_cell_reference` is
one step of `convgru_seq.gru_sequence_reference`.

`gru_cell_fused` launches the hand-written CUDA kernel
(`csrc/convgru_cell.cu`) for CUDA tensors and takes the plain version only
for CPU tensors. The kernel has two forms, chosen from the plane's shape
(`single_launch`): planes up to 8 × 8 take ONE launch in which a CTA owns a
batch element's whole plane and keeps r⊙h in shared memory; larger planes
take K1's gate launch and candidate launch through K1's library
(`convgru_seq.Steps`: a CTA cannot wait for its neighbours' r⊙h), with
r⊙h and z in scratch, so there the step is K1's bit for bit. In bf16 the
one-launch form sums on the CUDA cores and K1 on the tensor cores, in
another order. No (T, …) sequence buffer is made either way.

Under autograd the forward saves its inputs and h', and the backward is K2
at T = 1 (`convgru_bwd.gru_sequence_bwd`). The reference's cell has no
backward kernel: it differentiates a plain recompute whose gates stay in
the activation dtype (`_cell_recompute_bwd`), so in bf16 the two backwards
round at different places; in f32 they agree.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from dvdgan_tpu_torch.kernels import _build, convgru_bwd
from dvdgan_tpu_torch.kernels.convgru_blocked import MAX_SMEM_BYTES
from dvdgan_tpu_torch.kernels.convgru_seq import (
    _DTYPE_CODES, _pixel_strides, device_index, gru_sequence_reference,
    Steps, validate)

# the one-launch form's CTA holds a whole plane of at most this many rows
# and columns (its tile, `csrc/convgru_cell.cu`)
PLANE_MAX = 8


def gru_cell_reference(gx, cx, h, wg, wc):
    """Plain PyTorch version of the kernel: one step of K1's plain
    version."""
    return gru_sequence_reference(gx[None], cx[None], h, wg, wc)[0]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convgru_cell")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.convgru_cell_plane_step.argtypes = [i, i, p, p, i64, i64, p, i64, i64,
                                            p, p, p, i, i, i, i, p]
    lib.convgru_cell_plane_step.restype = i
    lib.convgru_cell_plane_smem_bytes.argtypes = [i, i, i, i]
    lib.convgru_cell_plane_smem_bytes.restype = i64
    lib.convgru_cell_error_string.argtypes = [i]
    lib.convgru_cell_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.convgru_cell_error_string(err).decode()
        raise RuntimeError(f"convgru_cell {what} launch failed: {msg} ({err})")


def single_launch(h: int, w: int, smem_bytes: int) -> bool:
    """True where a plane of h × w pixels takes the one-launch form: it
    fits one CTA's tile, and its r⊙h plane (all channels) with the staging
    buffers fits the CTA's shared memory (`smem_bytes`, from the
    library)."""
    return h <= PLANE_MAX and w <= PLANE_MAX and smem_bytes <= MAX_SMEM_BYTES


def _forward(gx, cx, h, wg, wc):
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    if gx.dim() != 4:
        raise ValueError(f"convgru_cell: want gx (B,H,W,2C), got "
                         f"{tuple(gx.shape)}")
    gx5, cx5 = gx[None], cx[None]
    device = validate({"gx": gx5, "cx": cx5, "h0": h, "wg": wg, "wc": wc},
                      contiguous=("h0", "wg", "wc"))
    if device.type == "cpu":
        return gru_cell_reference(gx, cx, h, wg, wc)
    gx_b, gx_pix = _pixel_strides(gx5, "gx")
    cx_b, cx_pix = _pixel_strides(cx5, "cx")
    b, hh, ww, c = h.shape

    lib = _lib()
    code = _DTYPE_CODES[h.dtype]
    dev = device_index(device)
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(device).cuda_stream
    if single_launch(hh, ww, lib.convgru_cell_plane_smem_bytes(code, hh, ww,
                                                               c)):
        err = lib.convgru_cell_plane_step(
            code, dev, h.data_ptr(), gx.data_ptr(), gx_b, gx_pix,
            cx.data_ptr(), cx_b, cx_pix, wg.data_ptr(), wc.data_ptr(),
            out.data_ptr(), b, hh, ww, c, stream)
        _check(lib, err, "plane")
        gru_cell_fused.launches += 1
        return out
    Steps(gx5, cx5, h, wg, wc, device).run(
        gru_cell_fused, h.data_ptr(), gx.data_ptr(), cx.data_ptr(),
        out.data_ptr())
    return out


class _GruCell(torch.autograd.Function):
    """Saves the inputs and h'; the backward is K2 over the one step."""

    @staticmethod
    def forward(ctx, gx, cx, h, wg, wc):
        out = _forward(gx, cx, h, wg, wc)
        ctx.save_for_backward(gx, cx, h, wg, wc, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gx, cx, h, wg, wc, out = ctx.saved_tensors
        dgx, dcx, dh, dwg, dwc = convgru_bwd.gru_sequence_bwd(
            gx[None], cx[None], h, wg, wc, out[None], g.contiguous()[None])
        return dgx[0], dcx[0], dh, dwg, dwc


def gru_cell_fused(gx, cx, h, wg, wc):
    """K4 forward. gx (B,H,W,2C), cx (B,H,W,C), h (B,H,W,C), wg (3,3,C,2C),
    wc (3,3,C,C) -> h' (B,H,W,C), differentiable in all five (backward
    through K2). Without a graph to build nothing is saved."""
    args = (gx, cx, h, wg, wc)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _GruCell.apply(*args)
    return _forward(*args)


# kernel launches made by gru_cell_fused (one per call for planes up to
# 8 × 8, two for larger ones)
gru_cell_fused.launches = 0
