"""Fused spatial self-attention, K6a and K6b — the counterpart of
`dvdgan_tpu/kernels/attention_spatial.py` (`spatial_attn_fused`,
`spatial_attn_tiled`).

Per frame of x (N, H, W, C), with kv = 2×2 max-pool(x) (H·W/4 tokens):

    q = x·Wq (C→C/8)   k = kv·Wk (C→C/8)   v = kv·Wv (C→C/2)
    out = x + γ·softmax(q kᵀ)·v·Wo          (f32 softmax, no 1/√d)

Weights are (C, C/8), (C, C/8), (C, C/2), (C/2, C); γ is a 0-d f32 tensor.

On the TPU K6a holds a whole frame's logits on chip and K6b tiles the query
rows for the maps K6a cannot hold. No SM holds a frame's logits (1 MB f32 at
32×32), so here both entries run ONE hand-written, query-tiled CUDA kernel
(`csrc/attention_spatial.cu`, two launches per call: the frame's k and v
once, then the query tiles); they differ in what they check and count:
`spatial_attn_fused` takes any map, `spatial_attn_tiled` also takes the
reference's test hook `force_bqr` (image rows per query tile), which must
divide H. CUDA tensors launch the kernel or raise; CPU tensors take the
plain version `spatial_attn_kernel_reference`, which rounds where the
kernel rounds (q, k and the logits stay f32; attn, v and o are rounded once
before the product that reads them; y = o·Wo is f32; out = f32(x) + γ·y is
rounded once).

Under autograd both are `torch.autograd.Function`s with the reference's
`custom_vjp` policy: the forward saves x, the four weights and γ, and the
backward is autograd through `spatial_attn_reference` — the reference's
oracle, which rounds q, k, v and the logits to the activation dtype, the
math of the unfused route — recomputed. The recompute holds the (N, H·W,
H·W/4) logits, so it walks the frames in chunks of at most
`BWD_CHUNK_ELEMS` logits; the weight gradients of the chunks are added in
f32 in frame order and cast once.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from dvdgan_tpu_torch.kernels import _build
from dvdgan_tpu_torch.kernels.convgru_seq import _DTYPE_CODES, device_index

_NAMES = ("x", "wq", "wk", "wv", "wo", "gamma")
# logits (frames × H·W × H·W/4) one chunk of the backward's recompute holds:
# 256 MB as f32 (16 frames at 64×64, 256 at 32×32)
BWD_CHUNK_ELEMS = 1 << 26


def _dims(x, wq, wk, wv, wo, gamma) -> tuple[int, ...]:
    """(N, H, W, C, c8, c2) of the arguments; raises on other shapes."""
    if x.dim() != 4:
        raise ValueError(f"spatial_attn: want x (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    n, h, w, c = x.shape
    if h % 2 or w % 2 or min(n, h, w, c) < 1:
        raise ValueError(f"spatial_attn: the 2×2 kv pool needs even H and W, "
                         f"got x {tuple(x.shape)}")
    c8, c2 = wq.shape[-1], wv.shape[-1]
    want = {"wq": (c, c8), "wk": (c, c8), "wv": (c, c2), "wo": (c2, c),
            "gamma": ()}
    for name, a in zip(_NAMES[1:], (wq, wk, wv, wo, gamma)):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"spatial_attn: {name} has shape "
                             f"{tuple(a.shape)}, want {want[name]}")
    return n, h, w, c, c8, c2


def _pool_tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H·W/4, C): 2×2 max pool, row-major tokens."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4)).reshape(
        n, -1, c)


def spatial_attn_kernel_reference(x, wq, wk, wv, wo, gamma) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the kernel's roundings."""
    n, h, w, c, _, _ = _dims(x, wq, wk, wv, wo, gamma)
    dt = x.dtype
    wq, wk, wv, wo = (a.to(dt).float() for a in (wq, wk, wv, wo))
    xt = x.reshape(n, h * w, c).float()
    kv = _pool_tokens(x).float()
    q = xt @ wq
    k = kv @ wk
    v = (kv @ wv).to(dt)
    attn = torch.softmax(q @ k.transpose(1, 2), dim=-1).to(dt)
    o = (attn.float() @ v.float()).to(dt)
    y = o.float() @ wo
    return (xt + gamma.float() * y).to(dt).reshape(x.shape)


def spatial_attn_reference(x, wq, wk, wv, wo, gamma) -> torch.Tensor:
    """The reference's oracle `_spatial_attn_reference`, the backward's
    math: every product in the activation dtype (q, k, v and the logits
    rounded to it), the softmax in f32."""
    n, h, w, c, _, _ = _dims(x, wq, wk, wv, wo, gamma)
    dt = x.dtype
    xt = x.reshape(n, h * w, c)
    kv = _pool_tokens(x)
    q = xt @ wq.to(dt)
    k = kv @ wk.to(dt)
    v = kv @ wv.to(dt)
    logits = torch.bmm(q, k.transpose(1, 2)).float()
    attn = torch.softmax(logits, dim=-1).to(dt)
    y = torch.bmm(attn, v) @ wo.to(dt)
    return (xt + gamma.to(dt) * y).reshape(x.shape)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of `csrc/attention_spatial.cu`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spatial_attn_plan.argtypes = [i] * 7
    lib.spatial_attn_kv.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.spatial_attn_fwd.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i,
                                     i, i, p]
    for name in ("spatial_attn_plan", "spatial_attn_kv", "spatial_attn_fwd"):
        getattr(lib, name).restype = i
    lib.spatial_attn_error_string.argtypes = [i]
    lib.spatial_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("attention_spatial"))


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.spatial_attn_error_string(err).decode()
        raise RuntimeError(f"attention_spatial {what} launch failed: {msg} "
                           f"({err})")


def _validate(args: dict[str, torch.Tensor]) -> torch.device:
    """The one device of `args`; on CUDA also: x and the weights share one
    kernel dtype, γ is f32, x is contiguous."""
    devices = {a.device for a in args.values()}
    if len(devices) != 1:
        raise ValueError(f"spatial_attn: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"spatial_attn: no kernel for device {device}")
    dtypes = {a.dtype for name, a in args.items() if name != "gamma"}
    if len(dtypes) != 1 or args["x"].dtype not in _DTYPE_CODES:
        raise TypeError(f"spatial_attn: x and the weights must share one "
                        f"dtype of {list(_DTYPE_CODES)}, got {dtypes}")
    if args["gamma"].dtype != torch.float32:
        raise TypeError(f"spatial_attn: gamma must be float32, got "
                        f"{args['gamma'].dtype}")
    if not args["x"].is_contiguous():
        raise ValueError("spatial_attn: x must be contiguous")
    return device


def _tile_queries(h: int, w: int, force_bqr: int | None) -> int:
    """Queries per tile that `force_bqr` image rows make (0: the kernel's
    own plan)."""
    if force_bqr is None:
        return 0
    if force_bqr < 1 or h % force_bqr:
        raise ValueError(f"spatial_attn_tiled: force_bqr={force_bqr} does "
                         f"not divide H={h}")
    return force_bqr * w


def _forward(entry, x, wq, wk, wv, wo, gamma, force_bqr=None) -> torch.Tensor:
    """The kernel on CUDA tensors (two launches, counted on `entry`), its
    plain version on CPU tensors."""
    n, h, w, c, c8, c2 = _dims(x, wq, wk, wv, wo, gamma)
    force_tq = _tile_queries(h, w, force_bqr)
    device = _validate(dict(zip(_NAMES, (x, wq, wk, wv, wo, gamma))))
    if device.type == "cpu":
        return spatial_attn_kernel_reference(x, wq, wk, wv, wo, gamma)
    lib = _lib()
    code, dev = _DTYPE_CODES[x.dtype], device_index(device)
    tq = lib.spatial_attn_plan(code, h, w, c, c8, c2, force_tq)
    if tq <= 0:
        raise ValueError(
            f"spatial_attn: the kernel does not take x {tuple(x.shape)} with "
            f"c8={c8}, c2={c2}" + (f", force_bqr={force_bqr}" if force_bqr
                                   else "")
            + (": no query tile fits shared memory (a forced tile must be a "
               "multiple of 16 queries that divides H·W)" if tq == 0 else
               ": it needs C % 16 == 0, c8 % 8 == 0, c2 % 16 == 0, H·W/4 % "
               "16 == 0 and projections that fit shared memory"))
    stream = torch.cuda.current_stream(device).cuda_stream
    kvn = (h // 2) * (w // 2)
    # the kernel's B operands are n-major: transposed weights, k and v
    wq_t, wk_t, wv_t, wo_t = (a.t().contiguous() for a in (wq, wk, wv, wo))
    k_t = torch.empty((n, c8, kvn), dtype=torch.float32, device=device)
    v_t = torch.empty((n, c2, kvn), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    err = lib.spatial_attn_kv(code, dev, x.data_ptr(), wk_t.data_ptr(),
                              wv_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
                              n, h, w, c, c8, c2, stream)
    _check(lib, err, "k/v")
    entry.launches += 1
    err = lib.spatial_attn_fwd(code, dev, x.data_ptr(), wq_t.data_ptr(),
                               wo_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
                               gamma.contiguous().data_ptr(), out.data_ptr(),
                               n, h, w, c, c8, c2, tq, stream)
    _check(lib, err, "attention")
    entry.launches += 1
    return out


class _SpatialAttn(torch.autograd.Function):
    """The reference's custom_vjp (`_fwd`/`_bwd`, `_tiled_fwd`/`_tiled_bwd`):
    saves the six inputs; the backward recomputes the oracle and goes back
    through it with autograd, a chunk of frames at a time."""

    @staticmethod
    def forward(ctx, entry, force_bqr, *args):
        ctx.save_for_backward(*args)
        return _forward(entry, *args, force_bqr)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *small = ctx.saved_tensors
        n, h, w, _ = x.shape
        chunk = max(1, BWD_CHUNK_ELEMS // (h * w * (h // 2) * (w // 2)))
        dx, dsmall = [], None
        for i in range(0, n, chunk):
            xi = x[i:i + chunk].detach().requires_grad_(True)
            leaves = [a.detach().requires_grad_(True) for a in small]
            with torch.enable_grad():
                out = spatial_attn_reference(xi, *leaves)
            dxi, *ds = torch.autograd.grad(out, (xi, *leaves), g[i:i + chunk])
            dx.append(dxi)
            if n <= chunk:
                dsmall = ds
            elif dsmall is None:
                dsmall = [d.float() for d in ds]
            else:
                dsmall = [a + d.float() for a, d in zip(dsmall, ds)]
        dsmall = [d.to(a.dtype) for d, a in zip(dsmall, small)]
        return (None, None, dx[0] if len(dx) == 1 else torch.cat(dx), *dsmall)


def _apply(entry, force_bqr, *args) -> torch.Tensor:
    """Without a graph to build nothing is saved."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _SpatialAttn.apply(entry, force_bqr, *args)
    return _forward(entry, *args, force_bqr)


def spatial_attn_fused(x, wq, wk, wv, wo, gamma) -> torch.Tensor:
    """K6a. x (N, H, W, C), H and W even -> x + γ·attention(x), same shape
    and dtype. Differentiable in all six arguments (recompute backward)."""
    return _apply(spatial_attn_fused, None, x, wq, wk, wv, wo, gamma)


def spatial_attn_tiled(x, wq, wk, wv, wo, gamma, force_bqr: int | None = None
                       ) -> torch.Tensor:
    """K6b: the same function through the entry for maps of 64×64 and up.
    `force_bqr` sets the query tile to that many image rows; it must divide
    H (and, on the card, make a tile the kernel takes)."""
    return _apply(spatial_attn_tiled, force_bqr, x, wq, wk, wv, wo, gamma)


# kernel launches made through each entry (two per call)
spatial_attn_fused.launches = 0
spatial_attn_tiled.launches = 0
LAUNCHES_PER_CALL = 2
