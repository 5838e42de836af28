"""Fused nearest-upsample-2× + SAME 3×3 conv, K5a (forward) and K5b
(backward) — the counterpart of `dvdgan_tpu/kernels/ups2x_fused.py:ups2x`.

Nearest-up-2× then a 3×3 conv is one 2×2-tap conv per output phase
(p, q) ∈ {0,1}² of the zero-padded source frame, interleaved:

    out[n, 2i+p, 2j+q, :] = Σ_{a,b∈{0,1}} xp[n, i+p+a, j+q+b, :]
                              · wall[(2a+b)·Cin : (2a+b+1)·Cin,
                                     (2p+q)·Cout : (2p+q+1)·Cout]

wall (4·Cin, 4·Cout) holds the phase kernels tap-major by rows and
phase-major by columns (`ops/layers.py` forms them from the 3×3 kernel, so
d(wall) → d(w) is plain autograd); xp is (N, H+2, W+2, Cin); out is
(N, 2H, 2W, Cout). f32 accumulation, one rounding to the activation dtype.

`ups2x(wall, xp, kernel_bwd)` launches the hand-written CUDA kernel K5a
(`csrc/ups2x_fused.cu`, one launch) for CUDA tensors and takes the plain
PyTorch version `ups2x_reference` only for CPU tensors. In bf16 the kernels
run their products on the tensor cores, in f32 on the CUDA cores (the
parity mode); each reads the weights in the layout its body wants
(`kernel_weights`). Under autograd it is a `torch.autograd.Function` with
the reference's `custom_vjp` policy: the forward saves wall and xp; with
`kernel_bwd` the backward is K5b (`ups2x_bwd`: two launches, dxp and dwall
accumulated in f32 and cast once), without it the backward is autograd
through the plain version, recomputed
(the reference's mode "fwd"). The reference gives way to its unfused route
where a level does not fit the TPU's VMEM; these kernels take every shape,
and the wrappers raise on what they cannot take.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from dvdgan_tpu_torch.kernels import _build
from dvdgan_tpu_torch.kernels.convgru_seq import _DTYPE_CODES, device_index

# the reference kernel adds the four tap products in this order
_TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _dims(wall: torch.Tensor, xp: torch.Tensor) -> tuple[int, ...]:
    """(N, H, W, Cin, Cout) of a (wall, xp) pair; raises on other shapes."""
    if xp.dim() != 4 or wall.dim() != 2:
        raise ValueError(f"ups2x: want wall (4·Cin, 4·Cout) and xp "
                         f"(N, H+2, W+2, Cin), got {tuple(wall.shape)} and "
                         f"{tuple(xp.shape)}")
    n, hp2, wp2, cin = xp.shape
    if (n < 1 or hp2 < 3 or wp2 < 3 or cin < 1 or wall.shape[0] != 4 * cin
            or wall.shape[1] % 4 or wall.shape[1] < 4):
        raise ValueError(f"ups2x: wall {tuple(wall.shape)} does not fit xp "
                         f"{tuple(xp.shape)}")
    return n, hp2 - 2, wp2 - 2, cin, wall.shape[1] // 4


def ups2x_reference(wall: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5a: per phase the four tap products in f32,
    added in the reference kernel's tap order, rounded once."""
    n, h, w, cin, cout = _dims(wall, xp)
    x32, w32 = xp.float(), wall.float()
    rows = []
    for p in (0, 1):
        cols = []
        for q in (0, 1):
            acc = None
            for k, (a, b) in enumerate(_TAPS):
                tap = x32[:, p + a:p + a + h, q + b:q + b + w, :]
                wk = w32[k * cin:(k + 1) * cin,
                         (2 * p + q) * cout:(2 * p + q + 1) * cout]
                term = tap @ wk
                acc = term if acc is None else acc + term
            cols.append(acc)
        rows.append(torch.stack(cols, dim=3))          # (N, H, W, 2, Cout)
    out = torch.stack(rows, dim=2)                     # (N, H, 2, W, 2, Cout)
    return out.reshape(n, 2 * h, 2 * w, cout).to(xp.dtype)


def ups2x_bwd_reference(wall: torch.Tensor, xp: torch.Tensor, g: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5b: (dwall (4·Cin, 4·Cout), dxp
    (N, H+2, W+2, Cin)), both f32, from the cotangent g (N, 2H, 2W, Cout)."""
    n, h, w, cin, cout = _dims(wall, xp)
    x32, w32, g32 = xp.float(), wall.float(), g.float()
    dxp = torch.zeros_like(x32)
    dwall = torch.zeros_like(w32)
    for p in (0, 1):
        for q in (0, 1):
            gpq = g32[:, p::2, q::2, :]                # (N, H, W, Cout)
            cols = slice((2 * p + q) * cout, (2 * p + q + 1) * cout)
            for k, (a, b) in enumerate(_TAPS):
                rows = slice(k * cin, (k + 1) * cin)
                window = (slice(None), slice(p + a, p + a + h),
                          slice(q + b, q + b + w))
                dxp[window] += gpq @ w32[rows, cols].t()
                dwall[rows, cols] = torch.einsum("nhwc,nhwd->cd",
                                                 x32[window], gpq)
    return dwall, dxp


def kernel_weights(wall: torch.Tensor, launch: str) -> torch.Tensor:
    """The weight operand of `launch` ("fwd": K5a; "dx": K5b's dxp) for
    `wall`'s dtype. The bf16 tensor-core bodies read B n-major ([n][k], k
    contiguous): K5a wall_t = wall.t() (rows phase·Cout + co, columns
    tap·Cin + ci), dxp wall itself (rows tap·Cin + ci, columns
    phase·Cout + co). The f32 bodies read the other two: K5a wall, dxp
    wall_t."""
    if (launch == "fwd") == (wall.dtype == torch.bfloat16):
        return wall.t().contiguous()
    return wall


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ups2x_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ups2x_fwd.argtypes = [i, i, p, p, p, i, i, i, i, i, p]
    lib.ups2x_bwd_dx.argtypes = [i, i, p, p, p, i, i, i, i, i, p]
    lib.ups2x_bwd_dw.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, p]
    lib.ups2x_dw_blocks.argtypes = [i, i, i]
    lib.ups2x_dw_slices.argtypes = [i, i, i, i, i, i]
    for name in ("ups2x_fwd", "ups2x_bwd_dx", "ups2x_bwd_dw",
                 "ups2x_dw_blocks", "ups2x_dw_slices"):
        getattr(lib, name).restype = i
    lib.ups2x_error_string.argtypes = [i]
    lib.ups2x_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ups2x_error_string(err).decode()
        raise RuntimeError(f"ups2x_fused {what} launch failed: {msg} ({err})")


def _validate(args: dict[str, torch.Tensor]) -> torch.device:
    """The one device of `args`; on CUDA also one kernel dtype, all
    contiguous."""
    devices = {a.device for a in args.values()}
    if len(devices) != 1:
        raise ValueError(f"ups2x: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"ups2x: no kernel for device {device}")
    dtypes = {a.dtype for a in args.values()}
    if len(dtypes) != 1 or dtypes.copy().pop() not in _DTYPE_CODES:
        raise TypeError(f"ups2x: inputs must share one dtype of "
                        f"{list(_DTYPE_CODES)}, got {dtypes}")
    for name, a in args.items():
        if not a.is_contiguous():
            raise ValueError(f"ups2x: {name} must be contiguous")
    return device


def _forward(wall: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """K5a on CUDA tensors, its plain version on CPU tensors."""
    n, h, w, cin, cout = _dims(wall, xp)
    device = _validate({"wall": wall, "xp": xp})
    if device.type == "cpu":
        return ups2x_reference(wall, xp)
    lib = _lib()
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=xp.dtype, device=device)
    w_fwd = kernel_weights(wall, "fwd")
    err = lib.ups2x_fwd(_DTYPE_CODES[xp.dtype], device_index(device),
                        xp.data_ptr(), w_fwd.data_ptr(), out.data_ptr(), n, h,
                        w, cin, cout,
                        torch.cuda.current_stream(device).cuda_stream)
    _check(lib, err, "forward")
    ups2x.launches += 1
    return out


def ups2x_bwd(wall: torch.Tensor, xp: torch.Tensor, g: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5b. -> (dwall (4·Cin, 4·Cout), dxp (N, H+2, W+2, Cin)), both f32,
    from the cotangent g (N, 2H, 2W, Cout) of `ups2x`'s output. Two
    launches on CUDA tensors (dxp; dwall, whose partial sums over slices of
    the frames are added in a fixed order: two runs give the same bits);
    the plain version on CPU tensors."""
    n, h, w, cin, cout = _dims(wall, xp)
    if tuple(g.shape) != (n, 2 * h, 2 * w, cout):
        raise ValueError(f"ups2x_bwd: g has shape {tuple(g.shape)}, want "
                         f"{(n, 2 * h, 2 * w, cout)}")
    device = _validate({"wall": wall, "xp": xp, "g": g})
    if device.type == "cpu":
        return ups2x_bwd_reference(wall, xp, g)
    lib = _lib()
    code, dev = _DTYPE_CODES[xp.dtype], device_index(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    f32 = dict(dtype=torch.float32, device=device)
    dxp = torch.empty(xp.shape, **f32)
    dwall = torch.empty(wall.shape, **f32)
    w_dx = kernel_weights(wall, "dx")
    err = lib.ups2x_bwd_dx(code, dev, g.data_ptr(), w_dx.data_ptr(),
                           dxp.data_ptr(), n, h, w, cin, cout, stream)
    _check(lib, err, "dxp")
    ups2x_bwd.launches += 1
    partial = torch.empty((lib.ups2x_dw_slices(code, n, h, w, cin, cout),
                           *wall.shape), **f32)
    counters = torch.zeros(lib.ups2x_dw_blocks(code, cin, cout),
                           dtype=torch.int32, device=device)
    err = lib.ups2x_bwd_dw(code, dev, xp.data_ptr(), g.data_ptr(),
                           partial.data_ptr(), dwall.data_ptr(),
                           counters.data_ptr(), n, h, w, cin, cout, stream)
    _check(lib, err, "dwall")
    ups2x_bwd.launches += 1
    return dwall, dxp


class _Ups2x(torch.autograd.Function):
    """The reference's custom_vjp (`_vjp_fwd`/`_vjp_bwd`): saves wall and
    xp. With `kernel_bwd` the backward is K5b, cast once; without it (mode
    "fwd") the backward recomputes the plain version and goes back through
    it with autograd."""

    @staticmethod
    def forward(ctx, wall, xp, kernel_bwd):
        ctx.save_for_backward(wall, xp)
        ctx.kernel_bwd = kernel_bwd
        return _forward(wall, xp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        wall, xp = ctx.saved_tensors
        if ctx.kernel_bwd:
            dwall, dxp = ups2x_bwd(wall, xp, g.contiguous())
            return dwall.to(wall.dtype), dxp.to(xp.dtype), None
        wall, xp = (a.detach().requires_grad_(True) for a in (wall, xp))
        with torch.enable_grad():
            out = ups2x_reference(wall, xp)
        return (*torch.autograd.grad(out, (wall, xp), g), None)


def ups2x(wall: torch.Tensor, xp: torch.Tensor, kernel_bwd: bool = True
          ) -> torch.Tensor:
    """Fused phase conv + interleave (K5a). wall (4·Cin, 4·Cout), xp
    (N, H+2, W+2, Cin) zero-padded -> (N, 2H, 2W, Cout). Differentiable in
    wall and xp: through K5b with `kernel_bwd`, else through the plain
    version, recomputed. Without a graph to build nothing is saved. While
    `torch.export` traces it, the registered op `dvdgan::ups2x` (forward
    only)."""
    if torch.compiler.is_exporting():
        return torch.ops.dvdgan.ups2x(wall, xp)
    if torch.is_grad_enabled() and (wall.requires_grad or xp.requires_grad):
        return _Ups2x.apply(wall, xp, kernel_bwd)
    return _forward(wall, xp)


# kernel launches made by ups2x (one per call) and by ups2x_bwd (two)
ups2x.launches = 0
ups2x_bwd.launches = 0
LAUNCHES_PER_CALL = 1
BWD_LAUNCHES_PER_CALL = 2
