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
for CPU tensors. The kernel has two forms, chosen from the plane's shape by
`plan`: planes up to 8 × 8 take ONE launch in which r⊙h and z never reach
device memory — in bf16 a thread-block cluster a batch element, each of its
`cluster` CTAs computing a slice of the output channels on the tensor cores
and gathering the others' r⊙h slices from their shared memory; in f32 (the
parity mode) a CTA a batch element on the CUDA cores —; larger planes take
K1's gate launch and candidate launch through K1's library
(`convgru_seq.Steps`: a CTA cannot wait for its neighbours' r⊙h), with r⊙h
and z in scratch, so there the step is K1's bit for bit. The bf16 cluster
form sums each output in K1's order (16-channel chunks, the nine taps of a
chunk summed from zero, each chunk added to the f32 total), so it has the
same bits under every cluster size; K1 at these planes cuts the
contraction into slices (split K) and adds their partial sums, another
order. No (T, …) sequence buffer is made either way.

Under autograd the forward saves its inputs and h', and the backward is K2
at T = 1 (`convgru_bwd.gru_sequence_bwd`). The reference's cell has no
backward kernel: it differentiates a plain recompute whose gates stay in
the activation dtype (`_cell_recompute_bwd`), so in bf16 the two backwards
round at different places; in f32 they agree.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.autograd.function import once_differentiable

from dvdgan_tpu_torch.kernels import _build, convgru_bwd
from dvdgan_tpu_torch.kernels.convgru_blocked import MAX_SMEM_BYTES
from dvdgan_tpu_torch.kernels.convgru_seq import (
    _DTYPE_CODES, _pixel_strides, device_index, gru_sequence_reference,
    Steps, validate)

# the one-launch form takes planes of at most this many rows and columns (a
# batch element's plane is one CTA's or one cluster's, `csrc/convgru_cell.cu`)
PLANE_MAX = 8
# the bf16 cluster form (`csrc/convgru_cell.cu`): input channels a chunk,
# weight chunks in flight, the most output channels a CTA (eight n-tiles
# of 8), cluster sizes (8 is the card's portable most; 16 needs its opt-in)
KC, STAGES, MAX_SLICE = 16, 3, 64
PORTABLE_CLUSTER, MAX_CLUSTER = 8, 16
# the f32 form's CTA tiles (conv3x3_tile.cuh `Tile`): its staging buffers in
# floats, for planes of up to 4 × 4 and up to 8 × 8
_F32_STAGING = {4: 4 * 6 * 6 + 9 * 4 * 256, 8: 16 * 10 * 10 + 9 * 16 * 64}


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """The one-launch form for a (b, h, w, c) step: `cluster` CTAs a batch
    element (f32: 1), each computing `slice` output channels, each asking
    for `smem_bytes` of shared memory; `tiles` = (m-tiles of 16 pixels,
    n-tiles of 8 channels) of a bf16 CTA's GEMM."""
    cluster: int
    slice: int
    smem_bytes: int
    tiles: tuple[int, int] = (0, 0)


def gru_cell_reference(gx, cx, h, wg, wc):
    """Plain PyTorch version of the kernel: one step of K1's plain
    version."""
    return gru_sequence_reference(gx[None], cx[None], h, wg, wc)[0]


def single_launch(h: int, w: int, smem_bytes: int) -> bool:
    """True where a plane of h × w pixels takes the one-launch form: it
    fits one CTA's (one cluster's) tile, and the CTA's plane with its
    staging buffers fits its shared memory (`smem_bytes`)."""
    return h <= PLANE_MAX and w <= PLANE_MAX and smem_bytes <= MAX_SMEM_BYTES


def cluster_tiles(h: int, w: int, c: int, k: int) -> tuple[int, int] | None:
    """(m-tiles, n-tiles) of a bf16 CTA where clusters of `k` CTAs take a
    plane of h × w pixels and c channels; None where they do not: k must
    divide c into slices of at most MAX_SLICE channels, whole 16-byte
    vectors where k > 1 (the exchange copies them), k ≤ MAX_CLUSTER."""
    if not (1 <= k <= MAX_CLUSTER and c % k == 0 and h <= PLANE_MAX
            and w <= PLANE_MAX):
        return None
    s = c // k
    n = -(-s // 8)
    if (k > 1 and s % 8) or n > 8:
        return None
    return (1 if h * w <= 16 else 4), 1 << (n - 1).bit_length()


def cluster_smem_bytes(h: int, w: int, c: int, ntt: int) -> int:
    """A bf16 CTA's shared memory: the plane (h·w rows and a zero row of C
    rounded up to whole chunks, + 8) and STAGES weight chunks (9 taps × 16
    rows of 2 · 8·ntt + 8), bf16."""
    ld = -(-c // KC) * KC + 8
    return 2 * ((h * w + 1) * ld + STAGES * 9 * KC * (16 * ntt + 8))


@functools.lru_cache(maxsize=256)
def plan(dtype: torch.dtype, b: int, h: int, w: int, c: int,
         force_cluster: int = 0) -> CellPlan | None:
    """The one-launch form of a (b, h, w, c) step, or None where the step
    takes K1's two launches (`single_launch` false: a plane over 8 × 8 or
    a CTA over the card's shared memory; bf16 also where no cluster size
    slices c). bf16: the most CTAs a cluster of at most PORTABLE_CLUSTER
    (MAX_CLUSTER where none smaller takes c) that slice c. `force_cluster`
    sets the cluster size (f32: 1); ValueError where the kernel does not
    take it. The plan changes no output bit."""
    if dtype == torch.float32:
        if force_cluster not in (0, 1):
            raise ValueError(f"convgru_cell: the f32 form runs one CTA a "
                             f"plane, not clusters of {force_cluster}")
        tile = 4 if h <= 4 and w <= 4 else 8
        smem = 4 * (_F32_STAGING[tile] + h * w * c)
        return CellPlan(1, c, smem) if single_launch(h, w, smem) else None
    sizes = ([force_cluster] if force_cluster else
             [*range(PORTABLE_CLUSTER, 0, -1), MAX_CLUSTER])
    for k in sizes:
        tiles = cluster_tiles(h, w, c, k)
        if tiles is None:
            continue
        smem = cluster_smem_bytes(h, w, c, tiles[1])
        if single_launch(h, w, smem):
            return CellPlan(k, c // k, smem, tiles)
    if force_cluster:
        raise ValueError(f"convgru_cell: the kernel does not take clusters "
                         f"of {force_cluster} at (B, H, W, C) {(b, h, w, c)}: "
                         f"a cluster size must divide C into slices of at "
                         f"most {MAX_SLICE} channels (multiples of 8 where it "
                         f"is over 1), at most {MAX_CLUSTER}, on planes of at "
                         f"most {PLANE_MAX}×{PLANE_MAX} within "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    return None


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convgru_cell")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.convgru_cell_plane_step.argtypes = [i, i, p, p, i64, i64, p, i64, i64,
                                            p, p, p, i, i, i, i, p]
    lib.convgru_cell_plane_step.restype = i
    lib.convgru_cell_plane_smem_bytes.argtypes = [i, i, i]
    lib.convgru_cell_plane_smem_bytes.restype = i64
    lib.convgru_cell_cluster_step.argtypes = [i, p, p, i64, i64, p, i64, i64,
                                              p, p, p, i, i, i, i, i, p]
    lib.convgru_cell_cluster_step.restype = i
    lib.convgru_cell_cluster_smem_bytes.argtypes = [i, i, i, i, p]
    lib.convgru_cell_cluster_smem_bytes.restype = i64
    lib.convgru_cell_error_string.argtypes = [i]
    lib.convgru_cell_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.convgru_cell_error_string(err).decode()
        raise RuntimeError(f"convgru_cell {what} launch failed: {msg} ({err})")


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
    pl = plan(h.dtype, b, hh, ww, c)
    out = torch.empty_like(h)
    if pl is None:
        Steps(gx5, cx5, h, wg, wc, device).run(
            gru_cell_fused, h.data_ptr(), gx.data_ptr(), cx.data_ptr(),
            out.data_ptr())
        return out
    lib = _lib()
    dev = device_index(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = (h.data_ptr(), gx.data_ptr(), gx_b, gx_pix, cx.data_ptr(), cx_b,
            cx_pix, wg.data_ptr(), wc.data_ptr(), out.data_ptr())
    if h.dtype == torch.bfloat16:
        err = lib.convgru_cell_cluster_step(dev, *ptrs, b, hh, ww, c,
                                            pl.cluster, stream)
        _check(lib, err, f"cluster ({pl.cluster} CTAs)")
    else:
        err = lib.convgru_cell_plane_step(_DTYPE_CODES[h.dtype], dev, *ptrs,
                                          b, hh, ww, c, stream)
        _check(lib, err, "plane")
    gru_cell_fused.launches += 1
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
