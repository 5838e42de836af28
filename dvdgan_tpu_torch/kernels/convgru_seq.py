"""Whole-sequence ConvGRU forward, K1 — the counterpart of
`dvdgan_tpu/kernels/convgru_seq.py:gru_sequence_fused`.

Layouts are the reference's, time-major: gx (T, B, H, W, 2C), cx
(T, B, H, W, C), h0 (B, H, W, C), wg (3, 3, C, 2C), wc (3, 3, C, C) ->
hs (T, B, H, W, C).

`gru_sequence_fused` launches the hand-written CUDA kernel
(`csrc/convgru_seq.cu`: one gate and one candidate launch per time step)
for CUDA tensors, and takes the plain PyTorch version
`gru_sequence_reference` only for CPU tensors. In bf16 each launch is an
implicit GEMM on the tensor cores (`csrc/conv3x3_mma.cuh`) run as `plan`
says: the CTA tile, and the slices of the contraction that give the small
planes enough CTAs, whose f32 partial sums go through one workspace per
call (`mma_args`). f32 runs the CUDA-core body. The math is the TPU kernel
body's (`convgru_cell.kernel_gru_step`), not `reference_cell`'s: gh is
accumulated in f32 and gx added in f32; r⊙h is formed in f32 and rounded
to the activation dtype before the candidate conv; the blend is f32 and the
output is rounded once.

Under autograd it is a `torch.autograd.Function` with the reference's
`custom_vjp` policy: the forward saves its inputs and the hidden sequence
hs it produced, and the backward is the reverse-time BPTT kernel K2
(`convgru_bwd.gru_sequence_bwd`) on CUDA tensors, its plain version on CPU
tensors. The reference takes K2 only at T ≥ 32 (a TPU v5e verdict); here
it is K2 at every T.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

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


# The bf16 tensor-core tiles of `csrc/conv3x3_mma.cuh`, by the index its C
# interface takes: (frames, rows, columns) of a CTA's pixel tile, its output
# channels and the chunks it keeps in flight. Four warps, 2 × 2 over pixels
# × channels.
MMA_TILES = ((2, 4, 4, 32, 5), (1, 4, 8, 32, 5), (2, 8, 8, 64, 3),
             (1, 8, 16, 64, 3))
MMA_KC = 16          # input channels a chunk: a k-step is one tap of one
TAPS = 9
MIN_CTAS = 132       # the H100's SMs: the least a launch should have
# steps of at most this many pixels × channels take 32-pixel tiles (an H100
# measurement: 8²×512 at B 8, 2¹⁸, runs faster on 128-pixel tiles and
# slices; 16²×256 at B 2, 2¹⁷, on 32-pixel tiles without)
SMALL_STEP = 1 << 17
# (input, output) channels of each launch of K1 and K2, in units of C
LAUNCH_CHANNELS = {"gate": (1, 2), "cand": (1, 1), "drh": (1, 1),
                   "dh": (2, 1)}


def mma_tile_smem(tile: int) -> int:
    """Shared memory of a CTA of tile `tile`, bytes: stages × (the pixel
    tile's (TH+2) × (TW+2) patch per frame, KC channels at a row stride of
    KC + 8; the nine taps' KC weight rows of BN channels at BN + 8),
    bf16."""
    tf, th, tw, bn, stages = MMA_TILES[tile]
    patch = tf * (th + 2) * (tw + 2) * (MMA_KC + 8)
    return stages * (patch + TAPS * MMA_KC * (bn + 8)) * 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one bf16 launch of K1 or K2 runs on the tensor cores. The grid
    is (m_tiles, n_blocks, slices); the contraction, 9 taps × Cin, is walked
    in `ksteps` k-steps of one tap of MMA_KC channels, chunk-major, and
    slice s takes `slice_bounds()[s]` of them. With more than one slice,
    each writes its f32 partial sums (`pixels` × `cout` of them) to the
    workspace and the last CTA of a tile adds them in slice order."""
    tile: int
    m_tiles: int
    n_blocks: int
    slices: int
    ksteps: int
    pixels: int
    cout: int

    @property
    def ctas(self) -> int:
        return self.m_tiles * self.n_blocks * self.slices

    @property
    def work_floats(self) -> int:
        return self.slices * self.pixels * self.cout if self.slices > 1 else 0

    @property
    def counters(self) -> int:
        return self.m_tiles * self.n_blocks if self.slices > 1 else 0

    @property
    def smem_bytes(self) -> int:
        return mma_tile_smem(self.tile)

    def slice_bounds(self) -> list[tuple[int, int]]:
        return [(s * self.ksteps // self.slices,
                 (s + 1) * self.ksteps // self.slices)
                for s in range(self.slices)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(b: int, h: int, w: int, c: int, launch: str) -> Plan:
    """The plan of `launch` (a key of LAUNCH_CHANNELS) at batch b, plane
    h × w and C = c. The tile: steps of at most SMALL_STEP pixels ×
    channels take 32 pixels a CTA (4×4 planes two frames, others 4×8
    tiles), larger ones 128 (planes up to 8×8 two frames, others 8×16
    tiles): the small tiles read each weight once per 32 pixels, the large
    ones once per 128 with more slices to sum. Where the tiles ×
    channel blocks are fewer than MIN_CTAS, the k-steps are cut into as
    many slices as bring the launch to MIN_CTAS (at most one k-step a
    slice)."""
    cin, cout = (k * c for k in LAUNCH_CHANNELS[launch])
    small_step = b * h * w * c <= SMALL_STEP
    if small_step:
        tile = 0 if h <= 4 and w <= 4 else 1
    else:
        tile = 2 if h <= 8 and w <= 8 else 3
    tf, th, tw, bn, _ = MMA_TILES[tile]
    m_tiles = _cdiv(b, tf) * _cdiv(h, th) * _cdiv(w, tw)
    n_blocks = _cdiv(cout, bn)
    ksteps = TAPS * _cdiv(cin, MMA_KC)
    tiles = m_tiles * n_blocks
    slices = 1 if tiles >= MIN_CTAS else min(ksteps, _cdiv(MIN_CTAS, tiles))
    return Plan(tile, m_tiles, n_blocks, slices, ksteps, b * h * w, cout)


def mma_args(b: int, h: int, w: int, c: int, launches, dtype, device):
    """The plan arguments of each launch of one call, (tile, slices, work
    pointer, counters pointer), and the workspace they point into: f32
    partial sums and zeroed counters, sized for the largest launch and
    shared by all (the launches run one after another on one stream, and
    each tile's last CTA sets its counter back to 0). f32 takes none."""
    if dtype != torch.bfloat16:
        return {name: (0, 1, None, None) for name in launches}, ()
    plans = {name: plan(b, h, w, c, name) for name in launches}
    n_work = max(p.work_floats for p in plans.values())
    n_counters = max(p.counters for p in plans.values())
    work = counters = None
    if n_work:
        work = torch.empty(n_work, dtype=torch.float32, device=device)
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    ptrs = (None, None) if work is None else (work.data_ptr(),
                                              counters.data_ptr())
    return ({name: (p.tile, p.slices, *ptrs) for name, p in plans.items()},
            (work, counters))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convgru_seq")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    plan_args = [i, i, p, p]          # tile, slices, work, counters
    lib.convgru_gate_step.argtypes = [i, i, p, p, i64, i64, p, p, p,
                                      i, i, i, i, *plan_args, p]
    lib.convgru_gate_step.restype = i
    lib.convgru_cand_step.argtypes = [i, i, p, p, i64, i64, p, p, p, p,
                                      i, i, i, i, *plan_args, p]
    lib.convgru_cand_step.restype = i
    lib.convgru_mma_tile.argtypes = [i, p]
    lib.convgru_mma_tile.restype = i
    lib.convgru_error_string.argtypes = [i]
    lib.convgru_error_string.restype = ctypes.c_char_p
    return lib


def mma_tile_info(tile: int) -> tuple[int, ...]:
    """(frames, rows, columns, output channels, stages, shared memory
    bytes) of tile `tile` as the built library has it (needs the CUDA
    toolkit)."""
    out = (ctypes.c_int * 6)()
    _check(_lib(), _lib().convgru_mma_tile(tile, ctypes.addressof(out)),
           "tile info")
    return tuple(out)


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


def validate(args: dict[str, torch.Tensor],
             contiguous: tuple[str, ...]) -> torch.device:
    """Shape, device and dtype checks shared by K1's and K2's wrappers.
    `args` holds gx, cx, h0, wg, wc and any (T, B, H, W, C) sequences (hs,
    g). Returns the one device; on CUDA also checks the dtype and that the
    `contiguous` inputs are."""
    gx, h0 = args["gx"], args["h0"]
    if h0.dim() != 4 or gx.dim() != 5:
        raise ValueError(f"convgru: want h0 (B,H,W,C) and gx (T,B,H,W,2C), "
                         f"got {tuple(h0.shape)} and {tuple(gx.shape)}")
    b, hh, ww, c = h0.shape
    t = gx.shape[0]
    want = {"gx": (t, b, hh, ww, 2 * c), "wg": (3, 3, c, 2 * c),
            "wc": (3, 3, c, c)}
    for name, a in args.items():
        shape = want.get(name, (t, b, hh, ww, c) if a.dim() == 5
                         else (b, hh, ww, c))
        if tuple(a.shape) != shape:
            raise ValueError(f"convgru: {name} has shape {tuple(a.shape)}, "
                             f"want {shape}")
    devices = {a.device for a in args.values()}
    if len(devices) != 1:
        raise ValueError(f"convgru: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"convgru: no kernel for device {device}")
    dtypes = {a.dtype for a in args.values()}
    if len(dtypes) != 1 or h0.dtype not in _DTYPE_CODES:
        raise TypeError(f"convgru: inputs must share one dtype of "
                        f"{list(_DTYPE_CODES)}, got {dtypes}")
    for name in contiguous:
        if not args[name].is_contiguous():
            raise ValueError(f"convgru: {name} must be contiguous")
    return device


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else (
        torch.cuda.current_device())


class Steps:
    """K1's launches for one call's shapes: the strides of gx and cx, the
    weights, the r⊙h and z scratch planes and the plan arguments with
    their workspace, made once; `run` makes one time step's gate and
    candidate launch from the device addresses of that step's planes. Also
    K4's two-launch form."""

    def __init__(self, gx, cx, h0, wg, wc, device):
        self.gx_b, self.gx_pix = _pixel_strides(gx, "gx")
        self.cx_b, self.cx_pix = _pixel_strides(cx, "cx")
        self.bhwc = tuple(h0.shape)
        self.code = _DTYPE_CODES[h0.dtype]
        self.dev = device_index(device)
        rh = torch.empty(h0.shape, dtype=h0.dtype, device=device)
        z = torch.empty(h0.shape, dtype=torch.float32, device=device)
        self.plans, workspace = mma_args(*self.bhwc, ("gate", "cand"),
                                         h0.dtype, device)
        # the tensors behind the addresses below, alive as long as this is
        self._keep = (rh, z, wg, wc, *workspace)
        self.rh, self.z = rh.data_ptr(), z.data_ptr()
        self.wg, self.wc = wg.data_ptr(), wc.data_ptr()
        self.stream = torch.cuda.current_stream(device).cuda_stream

    def run(self, counter, h_prev: int, gx_t: int, cx_t: int,
            h_out: int) -> None:
        """From h_prev, gx[t], cx[t] to h_out; each launch counted on
        `counter.launches`."""
        lib = _lib()
        err = lib.convgru_gate_step(self.code, self.dev, h_prev, gx_t,
                                    self.gx_b, self.gx_pix, self.wg, self.rh,
                                    self.z, *self.bhwc, *self.plans["gate"],
                                    self.stream)
        _check(lib, err, "gate")
        counter.launches += 1
        err = lib.convgru_cand_step(self.code, self.dev, self.rh, cx_t,
                                    self.cx_b, self.cx_pix, self.wc, self.z,
                                    h_prev, h_out, *self.bhwc,
                                    *self.plans["cand"], self.stream)
        _check(lib, err, "candidate")
        counter.launches += 1


def _forward(gx, cx, h0, wg, wc):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    device = validate({"gx": gx, "cx": cx, "h0": h0, "wg": wg, "wc": wc},
                      contiguous=("h0", "wg", "wc"))
    if device.type == "cpu":
        return gru_sequence_reference(gx, cx, h0, wg, wc)
    t = gx.shape[0]
    hs = torch.empty((t, *h0.shape), dtype=h0.dtype, device=device)
    steps = Steps(gx, cx, h0, wg, wc, device)
    # device addresses of step t's planes, hoisted out of the loop
    item = h0.element_size()
    hs0, hs_t = hs.data_ptr(), h0.numel() * item
    gx0, gx_t = gx.data_ptr(), gx.stride(0) * item
    cx0, cx_t = cx.data_ptr(), cx.stride(0) * item
    h_prev = h0.data_ptr()
    for step in range(t):
        h_out = hs0 + step * hs_t
        steps.run(gru_sequence_fused, h_prev, gx0 + step * gx_t,
                  cx0 + step * cx_t, h_out)
        h_prev = h_out
    return hs


def differentiable(forward):
    """`forward(gx, cx, h0, wg, wc) -> hs` under the reference's custom_vjp
    policy (`_fwd`/`_bwd`, shared by K1 and K3): the forward saves its
    inputs and hs, the backward is K2. Differentiable in all five inputs;
    without a graph to build (torch.no_grad(), or no input that requires
    grad) nothing is saved."""

    class GruSequence(torch.autograd.Function):
        @staticmethod
        def forward(ctx, gx, cx, h0, wg, wc):
            hs = forward(gx, cx, h0, wg, wc)
            ctx.save_for_backward(gx, cx, h0, wg, wc, hs)
            return hs

        @staticmethod
        @once_differentiable
        def backward(ctx, g):
            # convgru_bwd imports this module's helpers: imported here
            from dvdgan_tpu_torch.kernels import convgru_bwd
            return convgru_bwd.gru_sequence_bwd(*ctx.saved_tensors,
                                                g.contiguous())

    def entry(gx, cx, h0, wg, wc):
        args = (gx, cx, h0, wg, wc)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return GruSequence.apply(*args)
        return forward(*args)

    return entry


_differentiable_forward = differentiable(_forward)


def gru_sequence_fused(gx, cx, h0, wg, wc):
    """K1 forward. gx (T,B,H,W,2C), cx (T,B,H,W,C), h0 (B,H,W,C),
    wg (3,3,C,2C), wc (3,3,C,C) -> hs (T,B,H,W,C), differentiable
    (`differentiable`). While `torch.export` traces it, the registered op
    `dvdgan::gru_sequence_fused` (`kernels/library.py`)."""
    if torch.compiler.is_exporting():
        return torch.ops.dvdgan.gru_sequence_fused(gx, cx, h0, wg, wc)
    return _differentiable_forward(gx, cx, h0, wg, wc)


# kernel launches made by gru_sequence_fused (two per time step)
gru_sequence_fused.launches = 0
LAUNCHES_PER_STEP = 2
