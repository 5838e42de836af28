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
the plain version only for CPU tensors. In bf16 both convs run on the
tensor cores (`mma.sync`) with the tile `plan` chooses for the shape; f32
runs the CUDA-core body (one 8×8 tile). Under autograd it has K1's policy
(`convgru_seq.differentiable`): inputs and hs saved, backward through K2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from dvdgan_tpu_torch.kernels import _build
from dvdgan_tpu_torch.kernels.convgru_seq import (
    _DTYPE_CODES, _pixel_strides, device_index, differentiable,
    gru_sequence_reference, validate)

gru_sequence_blocked_reference = gru_sequence_reference

# dynamic shared memory a CTA may ask for on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448

# The bf16 tensor-core tiles of `csrc/convgru_blocked.cu`, by the index its
# C interface takes: (TH, TW) output pixels of a CTA, BN output channels a
# GEMM block, and the eight warps' rows along M in stage A (the rim's reset
# half) and stage B (update half and candidate). STAGES weight chunks of
# KC input channels × 9 taps in flight; THREADS a CTA.
TILES = ((8, 8, 64, 4, 4), (8, 16, 64, 4, 4), (16, 16, 32, 8, 8))
STAGES, KC, TAPS, THREADS = 3, 16, 9, 256
# one CTA an SM (`__launch_bounds__`, and 97–231 KB of shared memory): a
# grid of at least this many CTAs keeps 128 of the H100's 132 SMs busy
MIN_CTAS = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(tile: int, c: int) -> int:
    """Shared memory of a bf16 CTA of tile `tile` at C = c, bytes: the
    (TH+4) × (TW+4) h patch and the (TH+2) × (TW+2) r⊙h tile, all channels
    at a row stride of ceil16(C) + 8, and STAGES weight stages of 9·KC rows
    of BN + 8 (the formula of the kernel's `smem_bytes`)."""
    th, tw, bn = TILES[tile][:3]
    ldh = _cdiv(c, KC) * KC + 8
    pixels = (th + 4) * (tw + 4) + (th + 2) * (tw + 2)
    return (pixels * ldh + STAGES * TAPS * KC * (bn + 8)) * 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one bf16 launch of K3 runs: the tile, the grid's CTAs (B × the
    plane's tiles) and each CTA's shared memory."""
    tile: int
    ctas: int
    smem_bytes: int


def plan(b: int, h: int, w: int, c: int, tile: int | None = None) -> Plan:
    """The tile of K3's bf16 launches at batch b, plane h × w, C = c
    (`tile` forces one). The rule (`tools/torch_k3_tiles.py`, an H100
    measurement): of the tiles that fit shared memory, the largest whose
    grid has at least MIN_CTAS CTAs, else the one with most CTAs. A larger
    tile re-reads the weights less often and computes less rim, but a grid
    short of a wave leaves SMs idle: at 64²×128, B 2 the 8×8 tile (128
    CTAs) beats 8×16 (64) and 16×16 (32); at 128²×64, B 2 the 16×16 tile
    (128) beats the smaller ones (256, 512). Where none fits, the 8×8
    tile's plan, which the wrapper refuses."""
    def make(i):
        th, tw = TILES[i][:2]
        return Plan(i, b * _cdiv(h, th) * _cdiv(w, tw), smem_bytes(i, c))

    if tile is not None:
        return make(tile)
    fits = [make(i) for i in range(len(TILES))
            if smem_bytes(i, c) <= MAX_SMEM_BYTES]
    if not fits:
        return make(0)
    full = [p for p in fits if p.ctas >= MIN_CTAS]
    if full:
        return max(full, key=lambda p: TILES[p.tile][0] * TILES[p.tile][1])
    return max(fits, key=lambda p: p.ctas)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convgru_blocked")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.convgru_blocked_step.argtypes = [i, i, p, p, i64, i64, p, i64, i64,
                                         p, p, p, i, i, i, i, i, p]
    lib.convgru_blocked_step.restype = i
    lib.convgru_blocked_smem_bytes.argtypes = [i, i, i]
    lib.convgru_blocked_smem_bytes.restype = i64
    lib.convgru_blocked_tile.argtypes = [i, p]
    lib.convgru_blocked_tile.restype = i
    lib.convgru_blocked_error_string.argtypes = [i]
    lib.convgru_blocked_error_string.restype = ctypes.c_char_p
    return lib


def tile_info(tile: int) -> tuple[int, ...]:
    """(TH, TW, BN, stage-A warp rows, stage-B warp rows, stages, threads)
    of tile `tile` as the built library has it (needs the CUDA toolkit)."""
    out = (ctypes.c_int * 7)()
    if _lib().convgru_blocked_tile(tile, ctypes.addressof(out)) != 0:
        raise ValueError(f"convgru_blocked: no tile {tile}")
    return tuple(out)


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
    tile = plan(b, hh, ww, c).tile if h0.dtype == torch.bfloat16 else 0
    smem = lib.convgru_blocked_smem_bytes(code, c, tile)
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
            hs[step].data_ptr(), b, hh, ww, c, tile, stream)
        if err != 0:
            msg = lib.convgru_blocked_error_string(err).decode()
            raise RuntimeError(f"convgru_blocked launch failed: {msg} ({err})")
        gru_sequence_blocked.launches += 1
    return hs


_differentiable_forward = differentiable(_forward)


def gru_sequence_blocked(gx, cx, h0, wg, wc):
    """K3 forward, K1's signature: -> hs (T,B,H,W,C), differentiable
    (`convgru_seq.differentiable`). While `torch.export` traces it, the
    registered op `dvdgan::gru_sequence_blocked`."""
    if torch.compiler.is_exporting():
        return torch.ops.dvdgan.gru_sequence_blocked(gx, cx, h0, wg, wc)
    return _differentiable_forward(gx, cx, h0, wg, wc)


# kernel launches made by gru_sequence_blocked (one per time step)
gru_sequence_blocked.launches = 0
LAUNCHES_PER_STEP = 1
