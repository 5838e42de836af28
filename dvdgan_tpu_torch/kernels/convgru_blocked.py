"""Spatially blocked whole-sequence ConvGRU forward, K3 — the counterpart of
`dvdgan_tpu/kernels/convgru_blocked.py:gru_sequence_blocked`, the forward
for the generator's large planes (`ops/convgru.py` chooses between K1 and
K3 by the plane's size).

Layouts and math are K1's (`convgru_seq`): gx (T, B, H, W, 2C), cx
(T, B, H, W, C), h0 (B, H, W, C), wg (3, 3, C, 2C), wc (3, 3, C, C) ->
hs (T, B, H, W, C); gh and gx summed in f32, r⊙h rounded to the activation
dtype before the candidate conv, the blend in f32 rounded once. So K3's
plain version is K1's, `gru_sequence_reference`.

`gru_sequence_blocked` launches the hand-written CUDA kernel
(`csrc/convgru_blocked.cu`: ONE launch per time step; each CTA owns a
spatial tile with all its channels, recomputes the reset gate on a
one-pixel rim and keeps r⊙h in shared memory) for CUDA tensors, and takes
the plain version only for CPU tensors. Under autograd it has K1's policy
(`convgru_seq.differentiable`): inputs and hs saved, backward through K2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dvdgan_tpu_torch.kernels import _build
from dvdgan_tpu_torch.kernels.convgru_seq import (
    _DTYPE_CODES, _pixel_strides, device_index, differentiable,
    gru_sequence_reference, validate)

gru_sequence_blocked_reference = gru_sequence_reference

# dynamic shared memory a CTA may ask for on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convgru_blocked")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.convgru_blocked_step.argtypes = [i, i, p, p, i64, i64, p, i64, i64,
                                         p, p, p, i, i, i, i, p]
    lib.convgru_blocked_step.restype = i
    lib.convgru_blocked_smem_bytes.argtypes = [i, i]
    lib.convgru_blocked_smem_bytes.restype = i64
    lib.convgru_blocked_error_string.argtypes = [i]
    lib.convgru_blocked_error_string.restype = ctypes.c_char_p
    return lib


def _forward(gx, cx, h0, wg, wc):
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    device = validate({"gx": gx, "cx": cx, "h0": h0, "wg": wg, "wc": wc},
                      contiguous=("h0", "wg", "wc"))
    if device.type == "cpu":
        return gru_sequence_blocked_reference(gx, cx, h0, wg, wc)
    gx_b, gx_pix = _pixel_strides(gx, "gx")
    cx_b, cx_pix = _pixel_strides(cx, "cx")
    t = gx.shape[0]
    b, hh, ww, c = h0.shape

    lib = _lib()
    code = _DTYPE_CODES[h0.dtype]
    smem = lib.convgru_blocked_smem_bytes(code, c)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"convgru_blocked: C={c} in {h0.dtype} needs {smem} "
                         f"bytes of shared memory per CTA, over the card's "
                         f"{MAX_SMEM_BYTES}")
    dev = device_index(device)
    hs = torch.empty((t, b, hh, ww, c), dtype=h0.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for step in range(t):
        h_prev = h0 if step == 0 else hs[step - 1]
        err = lib.convgru_blocked_step(
            code, dev, h_prev.data_ptr(), gx[step].data_ptr(), gx_b, gx_pix,
            cx[step].data_ptr(), cx_b, cx_pix, wg.data_ptr(), wc.data_ptr(),
            hs[step].data_ptr(), b, hh, ww, c, stream)
        if err != 0:
            msg = lib.convgru_blocked_error_string(err).decode()
            raise RuntimeError(f"convgru_blocked launch failed: {msg} ({err})")
        gru_sequence_blocked.launches += 1
    return hs


_differentiable_forward = differentiable(_forward)


def gru_sequence_blocked(gx, cx, h0, wg, wc):
    """K3 forward, K1's signature: -> hs (T,B,H,W,C), differentiable
    (`convgru_seq.differentiable`)."""
    return _differentiable_forward(gx, cx, h0, wg, wc)


# kernel launches made by gru_sequence_blocked (one per time step)
gru_sequence_blocked.launches = 0
LAUNCHES_PER_STEP = 1
