"""Whole-sequence ConvGRU forward, K1 — the counterpart of
`dvdgan_tpu/kernels/convgru_seq.py:gru_sequence_fused`.

Layouts are the reference's, time-major: gx (T, B, H, W, 2C), cx
(T, B, H, W, C), h0 (B, H, W, C), wg (3, 3, C, 2C), wc (3, 3, C, C) ->
hs (T, B, H, W, C).

`gru_sequence_fused` launches the hand-written CUDA kernel
(`csrc/convgru_seq.cu`: one gate and one candidate launch per time step)
for CUDA tensors, and takes the plain PyTorch version
`gru_sequence_reference` only for CPU tensors. The math is the TPU kernel
body's (`convgru_cell.kernel_gru_step`), not `reference_cell`'s: gh is
accumulated in f32 and gx added in f32; r⊙h is formed in f32 and rounded
to the activation dtype before the candidate conv; the blend is f32 and the
output is rounded once.

Sampling only: the backward (an autograd.Function over the saved hs) lands
with the training slice, so an input that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dvdgan_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3×3 conv, NHWC in/out, HWIO kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def gru_sequence_reference(gx, cx, h0, wg, wc):
    """Plain PyTorch version of the kernel: f32-upcast F.conv2d per step,
    rounding to the activation dtype exactly where the kernel rounds."""
    dt = h0.dtype
    c = h0.shape[-1]
    wg32, wc32 = wg.float(), wc.float()
    h = h0
    hs = []
    for t in range(gx.shape[0]):
        h32 = h.float()
        rz = torch.sigmoid(gx[t].float() + _conv3x3(h32, wg32))
        r, z = rz[..., :c], rz[..., c:]
        rh = (r * h32).to(dt)
        cand = torch.tanh(cx[t].float() + _conv3x3(rh.float(), wc32))
        h = ((1.0 - z) * h32 + z * cand).to(dt)
        hs.append(h)
    return torch.stack(hs)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convgru_seq")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.convgru_gate_step.argtypes = [i, i, p, p, i64, i64, p, p, p,
                                      i, i, i, i, p]
    lib.convgru_gate_step.restype = i
    lib.convgru_cand_step.argtypes = [i, i, p, p, i64, i64, p, p, p, p,
                                      i, i, i, i, p]
    lib.convgru_cand_step.restype = i
    lib.convgru_error_string.argtypes = [i]
    lib.convgru_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.convgru_error_string(err).decode()
        raise RuntimeError(f"convgru_seq {what} launch failed: {msg} ({err})")


def _pixel_strides(x: torch.Tensor, name: str) -> tuple[int, int]:
    """(batch stride, pixel stride) of a (T, B, H, W, Ch) input whose
    channels are unit-stride and whose pixels are evenly spaced — a
    contiguous tensor, a channel slice of one (the hoisted input conv's
    gx/cx halves), or a stride-0 broadcast over T (level 0's x_static)."""
    _, _, h, w, ch = x.shape
    s_t, s_b, s_h, s_w, s_c = x.stride()
    if s_c != 1 or s_w < ch or s_h != w * s_w or s_b < h * s_h or s_t < 0:
        raise ValueError(f"convgru_seq: {name} layout {tuple(x.stride())} for "
                         f"shape {tuple(x.shape)} is not channel-contiguous "
                         f"with evenly spaced pixels")
    return s_b, s_w


def gru_sequence_fused(gx, cx, h0, wg, wc):
    """K1 forward. gx (T,B,H,W,2C), cx (T,B,H,W,C), h0 (B,H,W,C),
    wg (3,3,C,2C), wc (3,3,C,C) -> hs (T,B,H,W,C)."""
    args = {"gx": gx, "cx": cx, "h0": h0, "wg": wg, "wc": wc}
    if torch.is_grad_enabled() and any(a.requires_grad for a in args.values()):
        raise NotImplementedError(
            "gru_sequence_fused: backward lands with the training slice; "
            "call under torch.no_grad()")
    if h0.dim() != 4 or gx.dim() != 5:
        raise ValueError(f"convgru_seq: want h0 (B,H,W,C) and gx (T,B,H,W,2C),"
                         f" got {tuple(h0.shape)} and {tuple(gx.shape)}")
    b, hh, ww, c = h0.shape
    t = gx.shape[0]
    want = {"gx": (t, b, hh, ww, 2 * c), "cx": (t, b, hh, ww, c),
            "wg": (3, 3, c, 2 * c), "wc": (3, 3, c, c)}
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"convgru_seq: {name} has shape "
                             f"{tuple(args[name].shape)}, want {shape}")
    devices = {a.device for a in args.values()}
    if len(devices) != 1:
        raise ValueError(f"convgru_seq: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return gru_sequence_reference(gx, cx, h0, wg, wc)
    if device.type != "cuda":
        raise ValueError(f"convgru_seq: no kernel for device {device}")
    dtypes = {a.dtype for a in args.values()}
    if len(dtypes) != 1 or h0.dtype not in _DTYPE_CODES:
        raise TypeError(f"convgru_seq: inputs must share one dtype of "
                        f"{list(_DTYPE_CODES)}, got {dtypes}")
    for name in ("h0", "wg", "wc"):
        if not args[name].is_contiguous():
            raise ValueError(f"convgru_seq: {name} must be contiguous")
    gx_b, gx_pix = _pixel_strides(gx, "gx")
    cx_b, cx_pix = _pixel_strides(cx, "cx")

    lib = _lib()
    code = _DTYPE_CODES[h0.dtype]
    dev = device.index if device.index is not None else torch.cuda.current_device()
    hs = torch.empty((t, b, hh, ww, c), dtype=h0.dtype, device=device)
    rh = torch.empty((b, hh, ww, c), dtype=h0.dtype, device=device)
    z = torch.empty((b, hh, ww, c), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for step in range(t):
        h_prev = h0 if step == 0 else hs[step - 1]
        err = lib.convgru_gate_step(code, dev, h_prev.data_ptr(),
                                    gx[step].data_ptr(), gx_b, gx_pix,
                                    wg.data_ptr(), rh.data_ptr(),
                                    z.data_ptr(), b, hh, ww, c, stream)
        _check(lib, err, "gate")
        gru_sequence_fused.launches += 1
        err = lib.convgru_cand_step(code, dev, rh.data_ptr(),
                                    cx[step].data_ptr(), cx_b, cx_pix,
                                    wc.data_ptr(), z.data_ptr(),
                                    h_prev.data_ptr(), hs[step].data_ptr(),
                                    b, hh, ww, c, stream)
        _check(lib, err, "candidate")
        gru_sequence_fused.launches += 1
    return hs


# kernel launches made by gru_sequence_fused (two per time step)
gru_sequence_fused.launches = 0
LAUNCHES_PER_STEP = 2
