"""Reverse-time BPTT of the whole-sequence ConvGRU, K2 — the counterpart of
`dvdgan_tpu/kernels/convgru_bwd.py:gru_sequence_bwd`.

`gru_sequence_bwd(gx, cx, h0, wg, wc, hs, g)` -> (dgx, dcx, dh0, dwg, dwc),
shapes as in `convgru_seq`; `g` is the upstream gradient of hs. Per
reversed step it recomputes the gates from h_{t-1} (h0 at t = 0) in f32
and carries dh from t+1 to t through the two transposed 3×3 convs. It
launches the hand-written CUDA kernel (`csrc/convgru_bwd.cu`: four launches
per step; in bf16 implicit GEMMs on the tensor cores run as
`convgru_seq.plan` says, with one split-K workspace per call) for CUDA
tensors, and takes the plain PyTorch version `gru_sequence_bwd_reference`
only for CPU tensors. Both round to the
activation dtype exactly where the TPU kernel does: rh, da_c (= dcx),
da_rz (= dgx) and the dh carry, each step.

The weight gradients are conv weight-grads over the folded T·B batch, in
the activation dtype (f32 accumulation, rounded once), outside the kernel,
as the reference computes them outside its Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dvdgan_tpu_torch.kernels import _build
from dvdgan_tpu_torch.kernels.convgru_seq import (
    _DTYPE_CODES, _conv3x3, _pixel_strides, device_index, mma_args, validate)


def _flip_t(w: torch.Tensor) -> torch.Tensor:
    """(3,3,Cin,Cout) -> the kernel of the transposed conv: spatially
    flipped, in/out channels swapped (contiguous)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _weight_grads(h0, hs, rh_seq, dgx, dcx, wg, wc):
    """dWg = wgrad(h_{t-1} sequence, dgx), dWc = wgrad(rh sequence, dcx),
    each over the folded (T·B) batch, in the weights' dtype."""
    t, b, hh, ww, c = hs.shape

    def wgrad(x, dy, w):
        x = x.reshape(t * b, hh, ww, x.shape[-1]).permute(0, 3, 1, 2)
        dy = dy.reshape(t * b, hh, ww, dy.shape[-1]).permute(0, 3, 1, 2)
        kh, kw, cin, cout = w.shape
        dw = torch.nn.grad.conv2d_weight(x, (cout, cin, kh, kw), dy,
                                         padding=1)
        return dw.permute(2, 3, 1, 0).to(w.dtype)

    h_prev_seq = torch.cat([h0[None], hs[:-1]])
    return wgrad(h_prev_seq, dgx, wg), wgrad(rh_seq, dcx, wc)


def gru_sequence_bwd_reference(gx, cx, h0, wg, wc, hs, g):
    """Plain PyTorch version of the kernel (f32-upcast F.conv2d per step),
    rounding where the kernel rounds. -> (dgx, dcx, dh0, dwg, dwc)."""
    dt = h0.dtype
    c = h0.shape[-1]
    wg32, wc32 = wg.float(), wc.float()
    wgt32, wct32 = _flip_t(wg).float(), _flip_t(wc).float()
    carry = torch.zeros_like(h0)
    dgx, dcx, rhs = [], [], []
    for t in reversed(range(gx.shape[0])):
        h32 = (h0 if t == 0 else hs[t - 1]).float()
        rz = torch.sigmoid(gx[t].float() + _conv3x3(h32, wg32))
        r, z = rz[..., :c], rz[..., c:]
        rh = (r * h32).to(dt)
        cand = torch.tanh(cx[t].float() + _conv3x3(rh.float(), wc32))

        gt = g[t].float() + carry.float()
        da_c = (gt * z * (1.0 - cand * cand)).to(dt)
        da_z = gt * (cand - h32) * z * (1.0 - z)
        dh = gt * (1.0 - z)
        drh = _conv3x3(da_c.float(), wct32)
        dh = dh + drh * r
        da_r = drh * h32 * r * (1.0 - r)
        da = torch.cat([da_r, da_z], dim=-1).to(dt)
        carry = (dh + _conv3x3(da.float(), wgt32)).to(dt)
        dgx.append(da)
        dcx.append(da_c)
        rhs.append(rh)
    dgx, dcx, rh_seq = (torch.stack(s[::-1]) for s in (dgx, dcx, rhs))
    dwg, dwc = _weight_grads(h0, hs, rh_seq, dgx, dcx, wg, wc)
    return dgx, dcx, carry, dwg, dwc


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convgru_bwd")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    plan_args = [i, i, p, p]          # tile, slices, work, counters
    lib.convgru_bwd_gate_step.argtypes = [i, i, p, p, i64, i64, p, p, p, p,
                                          i, i, i, i, *plan_args, p]
    lib.convgru_bwd_cand_step.argtypes = [i, i, p, p, i64, i64, p, p, p, p,
                                          p, p, p, p, i, i, i, i, *plan_args,
                                          p]
    lib.convgru_bwd_drh_step.argtypes = [i, i, p, p, p, p, p, p,
                                         i, i, i, i, *plan_args, p]
    lib.convgru_bwd_dh_step.argtypes = [i, i, p, p, p, p, i, i, i, i,
                                        *plan_args, p]
    for name in ("gate", "cand", "drh", "dh"):
        getattr(lib, f"convgru_bwd_{name}_step").restype = i
    lib.convgru_bwd_error_string.argtypes = [i]
    lib.convgru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.convgru_bwd_error_string(err).decode()
        raise RuntimeError(f"convgru_bwd {what} launch failed: {msg} ({err})")


def gru_sequence_bwd(gx, cx, h0, wg, wc, hs, g):
    """K2. -> (dgx (T,B,H,W,2C), dcx (T,B,H,W,C), dh0 (B,H,W,C),
    dwg (3,3,C,2C), dwc (3,3,C,C)); dgx and dcx are dense whatever the
    layout of gx and cx."""
    device = validate({"gx": gx, "cx": cx, "h0": h0, "wg": wg, "wc": wc,
                       "hs": hs, "g": g},
                      contiguous=("h0", "wg", "wc", "hs", "g"))
    if device.type == "cpu":
        return gru_sequence_bwd_reference(gx, cx, h0, wg, wc, hs, g)
    gx_b, gx_pix = _pixel_strides(gx, "gx")
    cx_b, cx_pix = _pixel_strides(cx, "cx")
    t = gx.shape[0]
    b, hh, ww, c = h0.shape

    lib = _lib()
    code = _DTYPE_CODES[h0.dtype]
    dev = device_index(device)
    dt = h0.dtype
    dgx = torch.empty((t, b, hh, ww, 2 * c), dtype=dt, device=device)
    dcx = torch.empty((t, b, hh, ww, c), dtype=dt, device=device)
    rh_seq = torch.empty((t, b, hh, ww, c), dtype=dt, device=device)
    carry = torch.zeros((b, hh, ww, c), dtype=dt, device=device)  # -> dh0
    r, z, dh = (torch.empty((b, hh, ww, c), dtype=torch.float32,
                            device=device) for _ in range(3))
    wgt, wct = _flip_t(wg), _flip_t(wc)
    plans, _workspace = mma_args(b, hh, ww, c, ("gate", "cand", "drh", "dh"),
                                 dt, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    bhwc = (b, hh, ww, c)
    # device addresses, and the stride of step t's planes, hoisted out of
    # the loop
    item = h0.element_size()
    plane = h0.numel() * item
    h0_p, hs_p, g_p = h0.data_ptr(), hs.data_ptr(), g.data_ptr()
    gx_p, gx_t = gx.data_ptr(), gx.stride(0) * item
    cx_p, cx_t = cx.data_ptr(), cx.stride(0) * item
    dgx_p, dcx_p, rh_p = dgx.data_ptr(), dcx.data_ptr(), rh_seq.data_ptr()
    r_p, z_p, dh_p, carry_p = (a.data_ptr() for a in (r, z, dh, carry))
    wg_p, wc_p, wgt_p, wct_p = (a.data_ptr() for a in (wg, wc, wgt, wct))
    for step in reversed(range(t)):
        h_prev = h0_p if step == 0 else hs_p + (step - 1) * plane
        rh_t, dcx_t = rh_p + step * plane, dcx_p + step * plane
        dgx_t = dgx_p + 2 * step * plane
        err = lib.convgru_bwd_gate_step(
            code, dev, h_prev, gx_p + step * gx_t, gx_b, gx_pix, wg_p, rh_t,
            r_p, z_p, *bhwc, *plans["gate"], stream)
        _check(lib, err, "gate")
        gru_sequence_bwd.launches += 1
        err = lib.convgru_bwd_cand_step(
            code, dev, rh_t, cx_p + step * cx_t, cx_b, cx_pix, wc_p, z_p,
            h_prev, g_p + step * plane, carry_p, dcx_t, dgx_t, dh_p, *bhwc,
            *plans["cand"], stream)
        _check(lib, err, "candidate")
        gru_sequence_bwd.launches += 1
        err = lib.convgru_bwd_drh_step(
            code, dev, dcx_t, wct_p, r_p, h_prev, dh_p, dgx_t, *bhwc,
            *plans["drh"], stream)
        _check(lib, err, "drh")
        gru_sequence_bwd.launches += 1
        err = lib.convgru_bwd_dh_step(
            code, dev, dgx_t, wgt_p, dh_p, carry_p, *bhwc, *plans["dh"],
            stream)
        _check(lib, err, "dh")
        gru_sequence_bwd.launches += 1
    dwg, dwc = _weight_grads(h0, hs, rh_seq, dgx, dcx, wg, wc)
    return dgx, dcx, carry, dwg, dwc


# kernel launches made by gru_sequence_bwd (four per time step)
gru_sequence_bwd.launches = 0
LAUNCHES_PER_STEP = 4
