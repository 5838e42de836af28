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
once, then the query rows); they differ in what they check and count:
`spatial_attn_fused` takes any map, `spatial_attn_tiled` also takes the
reference's test hook `force_bqr` (image rows per query tile), which must
divide H. CUDA tensors launch the kernel or raise; CPU tensors take the
plain version `spatial_attn_kernel_reference`, which rounds where the
kernel rounds (q, k and the logits stay f32; attn, v and o are rounded once
before the product that reads them; y = o·Wo is f32; out = f32(x) + γ·y is
rounded once).

In bf16 the second launch runs persistent CTAs whose warps own 16 query
rows each from x to out, with the logits on the tensor cores as 3×TF32
(`logits_3xtf32` is its plain emulation, for the tests); in f32 it runs the
CUDA-core body of the first version. `plan` picks the body, the queries of
a work item and the grid; the C interface checks what it is given.

The kernel takes every x with even H and W. A map whose H·W/4 keys are not
a multiple of 16 (4×4: 4 keys) runs with its k and v padded by zero tokens
and the padded keys' logits masked to −inf (in the kernel). Widths the
bodies do not read in place run zero-padded: `plan` gives the widths the
kernel runs at (`Plan.c`, `c8`, `c2`), and `_forward` pads the weights to
them (zero columns of Wq, Wk and Wv, zero rows of Wo: exact, a few KB).
Only where C itself is padded (C % 16 ≠ 0, in bf16 C % 32 ≠ 0: the bf16
bodies read x in 32-channel chunks; no preset width) is x copied into a
wider tensor, and out sliced back.

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
import dataclasses
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


def spatial_attn_kernel_reference(x, wq, wk, wv, wo, gamma,
                                  logits=torch.matmul) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the kernel's roundings.
    `logits(q, kT)` forms the f32 logits (the tests pass `logits_3xtf32`,
    the bf16 kernel's product)."""
    n, h, w, c, _, _ = _dims(x, wq, wk, wv, wo, gamma)
    dt = x.dtype
    wq, wk, wv, wo = (a.to(dt).float() for a in (wq, wk, wv, wo))
    xt = x.reshape(n, h * w, c).float()
    kv = _pool_tokens(x).float()
    q = xt @ wq
    k = kv @ wk
    v = (kv @ wv).to(dt)
    attn = torch.softmax(logits(q, k.transpose(1, 2)), dim=-1).to(dt)
    o = (attn.float() @ v.float()).to(dt)
    y = o.float() @ wo
    return (xt + gamma.float() * y).to(dt).reshape(x.shape)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 (10 stored significand bits) as `cvt.rna.tf32.f32` rounds:
    to nearest, ties away from zero, on the bit pattern; returned as f32
    with the 13 low bits clear. Finite inputs."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def logits_3xtf32(q: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """q (…, M, D) @ kt (…, D, K) as the bf16 kernel forms the logits on the
    tensor cores: each f32 operand split into hi = tf32(v) and lo =
    tf32(v − hi), then hi·hi + hi·lo + lo·hi in f32 (lo·lo dropped)."""
    q_hi, k_hi = tf32_rna(q), tf32_rna(kt)
    q_lo, k_lo = tf32_rna(q - q_hi), tf32_rna(kt - k_hi)
    return q_lo @ k_hi + q_hi @ k_lo + q_hi @ k_hi


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


# The bf16 bodies of `csrc/attention_spatial.cu` (its BODY_TABLE), by the
# index its C interface takes: (mode, OT, most warps a CTA). Mode 0 keeps a
# row's logits in registers (maps of exactly RES_KEYS keys: 32×32), mode 1
# sweeps the keys three times (any other map), mode 2 is mode 1 with the
# frame's vᵀ read from L2, and its k too where k alone does not fit beside
# the weights: where k and vᵀ do not fit shared memory together (64×64 at
# C ≥ 128, larger maps). A warp holds OT o n-tiles and
# OT/4 q n-tiles of 8 channels (c2 ≤ 8·OT, c8 ≤ 2·OT). The most warps a CTA
# is also what an SM holds by registers (255 a thread at 8 warps, 128 at
# 16), so the persistent grid takes one such CTA an SM. Mode 3 takes the
# widths the others refuse on maps of at most WIDE_KEYS keys (the 4×4, 8×8
# and 16×16 attention at C 384 and up), mode 4 the same widths on larger
# maps (the 32×32 attention at C 384–1024, 64×64 at C 384–512). Neither the
# weights nor, in mode 4, the frame's k and vᵀ fit shared memory, and a warp
# that read them from L2 for its own 16 rows would read 0.58–2.95 MB a warp
# item. So a work item of theirs is tq queries of
# one frame on all of a CTA's warps at once, and Wq^T, the frame's split k,
# its vᵀ and Wo^T (the wrapper hands the weights transposed) stream through
# a ring of 10,240-byte tiles in shared memory that the warps take turns to
# copy (cp.async, full and empty mbarriers): each byte read from L2 serves
# the item's tq rows. The widths go in passes (q and the logits 32 q
# channels, attn·v 64 o channels, o·Wo 128 o channels a pass, each pass's
# sums promoted into f32 totals); mode 4 keeps a 32×32 row's 256 logits in
# registers and sweeps larger maps three times. Each warp keeps its o (mode
# 4 also q, and on maps of other than RES_KEYS keys attn) in a shared-memory
# buffer. Their products stay on mma.sync: what bounds them is the latency
# of each warp's chains at 8 warps an SM or fewer. Modes 3 and 4 take any
# width (c2 % 32 == 0; their OT is no limit) and run as many warps a CTA as
# their buffers fit beside the ring, at most the table's.
BODIES = ((0, 4, 8), (0, 16, 8), (1, 4, 16), (1, 8, 8), (1, 16, 8),
          (2, 4, 16), (2, 8, 8), (2, 16, 8), (3, 32, 8), (4, 32, 8))
RES_KEYS = 256
WIDE_KEYS = 64
# dynamic shared memory a CTA may ask for on sm_90 (227 KB); an SM's 228 KB
# less the 1 KB it keeps for each CTA
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES, CTA_RESERVED_BYTES = 233472, 1024
SMS = 132          # H100 SXM; `_forward` asks the card
MAX_WARPS_PER_SM = 64
# modes 3 and 4: the ring of tiles their warps share, as many stages of
# TILE_BYTES as fit beside the warps' buffers, MIN_STAGES to MAX_STAGES,
# and its barriers (two mbarriers a stage, MAX_STAGES of them)
TILE_BYTES, MIN_STAGES, MAX_STAGES = 10240, 3, 8
BAR_BYTES = 16 * MAX_STAGES


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the second launch runs: `body` (bf16: an index into BODIES; f32:
    -1, the CUDA-core body), `tq` queries a work item (f32: a CTA), the
    `items` (frame, tile) and the grid's `ctas` (f32: one an item), each
    CTA's `smem_bytes`; the widths C, c8 and c2 the kernel runs at (the
    call's, or zero-padded up to what the body reads)."""
    body: int
    tq: int
    items: int
    ctas: int
    smem_bytes: int
    c: int
    c8: int
    c2: int


def _up(v: int, m: int) -> int:
    """v rounded up to a multiple of m."""
    return -(-v // m) * m


def keys_padded(kvn: int) -> int:
    """The keys k and v hold for a frame of `kvn` pooled tokens: the next
    multiple of 16 (the kernel's `keys_padded`)."""
    return _up(kvn, 16)


def _f32_smem(tq: int, kvn: int, c: int, c8: int, c2: int) -> int:
    """The f32 body's x tile, logits tile, q and o (its `make_layout`)."""
    return 4 * tq * ((c + 4) + (kvn + 4) + c8 + (c2 + 4))


def _bf16_smem(kvn: int, c: int, c8: int, c2: int, v_staged: bool) -> int:
    """The bf16 body's Wq^T and Wo^T, v^T where `v_staged`, and the split k
    where v is staged or k fits beside the weights (its `tc_layout`)."""
    ldq = c + 32 if c % 64 == 0 else c
    head = 2 * (c8 * ldq + c * (c2 + 8)) + (2 * c2 * (kvn + 8) if v_staged
                                            else 0)
    with_k = head + 8 * c8 * kvn
    return with_k if v_staged or with_k <= MAX_SMEM_BYTES else head


def wide_tiles(mode: int, kvn: int, c: int, c8: int, c2: int) -> int:
    """The ring's tiles of a work item of mode 3 or 4 (its `wide_tiles`):
    q passes × blocks of C, the k tiles (mode 3: each q pass's; mode 4:
    each of the three sweeps', one on maps of RES_KEYS keys), vᵀ's, Wo^T's."""
    qp, cb = -(-c8 // 32), -(-c // 128)
    kb, vp, wo = -(-kvn // 32), -(-c2 // 64), (c // 32) * -(-c2 // 128)
    if mode == 3:
        return qp * (cb + kb) + vp + wo
    return (qp * cb + (1 if kvn == RES_KEYS else 3) * kb * qp
            + vp * -(-kvn // 64) + wo)


def _ring(mode: int, kvn: int, c: int, c8: int, c2: int, warps: int,
          warps_bytes: int) -> int:
    """The wide bodies' ring beside `warps_bytes` of the warps' buffers:
    its barriers, its table of an item's tiles (16 bytes each) and as many
    stages as fit, MIN_STAGES to MAX_STAGES, in the CTA's share of an SM
    that holds as many CTAs of `warps` as registers allow (8 / warps) where
    the least ring fits in it, else in MAX_SMEM_BYTES."""
    fixed = BAR_BYTES + 16 * wide_tiles(mode, kvn, c, c8, c2) + warps_bytes
    share = SM_SMEM_BYTES // max(1, 8 // warps) - CTA_RESERVED_BYTES
    budget = (share if share < MAX_SMEM_BYTES
              and fixed + MIN_STAGES * TILE_BYTES <= share
              else MAX_SMEM_BYTES)
    room = max(0, budget - fixed) // TILE_BYTES
    fixed -= warps_bytes
    return fixed + min(max(room, MIN_STAGES), MAX_STAGES) * TILE_BYTES


def _wide_smem(kvn: int, c: int, c8: int, c2: int, warps: int) -> int:
    """Mode 3's ring and a 16-row o buffer a warp (its `wide_layout`)."""
    own = warps * 32 * (c2 + 8)
    return _ring(3, kvn, c, c8, c2, warps, own) + own


def _wide_sweep_smem(kvn: int, c: int, c8: int, c2: int, warps: int) -> int:
    """Mode 4's ring and, a warp, its q buffer (which its o buffer reuses)
    and, on maps of other than RES_KEYS keys, its attn buffer (its
    `wide_layout`)."""
    attn = 32 * kvn if kvn != RES_KEYS else 0
    own = warps * (max(128 * c8, 32 * (c2 + 8)) + attn)
    return _ring(4, kvn, c, c8, c2, warps, own) + own


def _kv_fits(dtype: torch.dtype, kvn: int, c: int) -> bool:
    """The first launch's pooled tokens fit for some token tile (its
    `plan_kt`)."""
    row = 2 * (c + 32 if c % 64 == 0 else c) if dtype == torch.bfloat16 \
        else 4 * (c + 4)
    return any(kvn % kt == 0 and kt * row <= MAX_SMEM_BYTES
               for kt in (64, 32, 16))


def _body(mode: int, c8: int, c2: int) -> int | None:
    """The bf16 body of `mode` with the fewest o n-tiles that hold c2 and
    c8 (modes 3 and 4: any width); None where none does."""
    for i, (m, ot, _) in enumerate(BODIES):
        if m == mode and (mode >= 3 or c2 <= 8 * ot and c8 <= 2 * ot):
            return i
    return None


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, n: int, h: int, w: int, c: int, c8: int,
         c2: int, force_tq: int = 0, ctas: int | None = None,
         sms: int = SMS) -> Plan:
    """The second launch's plan for x (n, h, w, c) with c8, c2. The widths
    the kernel runs at: C a multiple of 16 (bf16: 32), c8 of 8, c2 of 16
    (modes 3 and 4: 32). Work items of `tq` queries: `force_tq` if given (a
    multiple of 16 that divides H·W and that the body takes), else the most
    the body takes that divides H·W (bf16: 16 per warp, as many warps as
    shared memory holds; f32: 64, 32 or 16 as shared memory allows).
    bf16: mode 0 on maps of RES_KEYS keys, else mode 1, mode 2 where k and
    vᵀ do not fit shared memory beside the weights, and where no warp of
    those holds the widths, mode 3 (at most WIDE_KEYS keys) or 4; one CTA of
    the body's size an SM as registers and shared memory allow, `sms` SMs,
    at most one CTA an item (`ctas` forces a grid; it changes no output
    bit). Raises ValueError for what the kernel does not take: odd H or W,
    a forced tile that does not divide H·W or fit, or a map whose buffers
    fit no CTA."""
    hw, kvn = h * w, keys_padded((h // 2) * (w // 2))
    what = (f"spatial_attn: the kernel does not take x {(n, h, w, c)} with "
            f"c8={c8}, c2={c2}")
    bf16 = dtype == torch.bfloat16
    if h % 2 or w % 2 or min(n, h, w, c, c8, c2) < 1:
        raise ValueError(what + ": it needs even H and W (the 2×2 kv pool)")
    c, c8, c2 = _up(c, 32 if bf16 else 16), _up(c8, 8), _up(c2, 16)
    if not _kv_fits(dtype, kvn, c):
        raise ValueError(what + ": the first launch's pooled tokens do not "
                         "fit shared memory")
    fits = None                 # modes 3 and 4: their buffers for tq queries
    if bf16:
        # the mode by the keys; mode 2 where the frame's k and v^T do not fit
        mode = 0 if (h // 2) * (w // 2) == RES_KEYS else 1
        smem = _bf16_smem(kvn, c, c8, c2, True)
        if smem > MAX_SMEM_BYTES:
            mode, smem = 2, _bf16_smem(kvn, c, c8, c2, False)
        body = _body(mode, c8, c2)
        if body is None or smem > MAX_SMEM_BYTES:
            c2 = _up(c2, 32)
            mode = 3 if kvn <= WIDE_KEYS else 4
            body = _body(mode, c8, c2)
            layout = _wide_smem if mode == 3 else _wide_sweep_smem
            fits = functools.partial(layout, kvn, c, c8, c2)
        most = 16 * BODIES[body][2]
        sizes = [tq for tq in (most, most // 2, most // 4, most // 8,
                               most // 16) if tq >= 16]
        if fits is not None:
            sizes = [tq for tq in sizes if fits(tq // 16) <= MAX_SMEM_BYTES]
    else:
        body, most = -1, 64
        sizes = [tq for tq in (most, 32, 16)
                 if _f32_smem(tq, kvn, c, c8, c2) <= MAX_SMEM_BYTES]
    if force_tq:
        ok = force_tq % 16 == 0 and (
            force_tq <= most and (fits is None
                                  or fits(force_tq // 16) <= MAX_SMEM_BYTES)
            if bf16 else
            _f32_smem(force_tq, kvn, c, c8, c2) <= MAX_SMEM_BYTES)
        sizes = [force_tq] if ok else []
    sizes = [tq for tq in sizes if hw % tq == 0]
    if not sizes:
        raise ValueError(what + f", {force_tq or 'any'} queries a tile: no "
                         f"query tile fits (a forced tile must be a multiple "
                         f"of 16 queries that divides H·W and fits: in bf16 "
                         f"at most {most})")
    tq = sizes[0]
    items = n * (hw // tq)
    if not bf16:
        return Plan(-1, tq, items, items, _f32_smem(tq, kvn, c, c8, c2),
                    c, c8, c2)
    warps = tq // 16
    if fits is not None:
        smem = fits(warps)
    per_sm = min(SM_SMEM_BYTES // (smem + CTA_RESERVED_BYTES),
                 BODIES[body][2] // warps, MAX_WARPS_PER_SM // warps)
    grid = sms * per_sm if ctas is None else ctas
    return Plan(body, tq, items, max(1, min(grid, items)), smem, c, c8, c2)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of `csrc/attention_spatial.cu`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spatial_attn_smem_bytes.argtypes = [i] * 8
    lib.spatial_attn_smem_bytes.restype = ctypes.c_longlong
    lib.spatial_attn_kv_tokens.argtypes = [i] * 4
    lib.spatial_attn_body.argtypes = [i, p]
    lib.spatial_attn_kv.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.spatial_attn_fwd.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i,
                                     i, i, i, i, p]
    for name in ("spatial_attn_kv_tokens", "spatial_attn_body",
                 "spatial_attn_kv", "spatial_attn_fwd"):
        getattr(lib, name).restype = i
    lib.spatial_attn_error_string.argtypes = [i]
    lib.spatial_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("attention_spatial"))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    dev = device_index(device)
    pl = plan(x.dtype, n, h, w, c, c8, c2, force_tq=force_tq, sms=_sms(dev))
    # zero-padded to the widths the kernel runs at: columns of Wq, Wk and
    # Wv and rows of Wo (exact); C: rows of the first three, columns of Wo,
    # and x's channels (a copy; out is sliced back)
    dc, d8, d2 = pl.c - c, pl.c8 - c8, pl.c2 - c2
    if dc or d8 or d2:
        pad = torch.nn.functional.pad
        wq, wk = pad(wq, (0, d8, 0, dc)), pad(wk, (0, d8, 0, dc))
        wv, wo = pad(wv, (0, d2, 0, dc)), pad(wo, (0, dc, 0, d2))
        if dc:
            x = pad(x, (0, dc))
    c, c8, c2 = pl.c, pl.c8, pl.c2
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    stream = torch.cuda.current_stream(device).cuda_stream
    kvn = keys_padded((h // 2) * (w // 2))
    # the first launch reads the k and v projections transposed, and so do
    # the f32 body and the bf16 modes 3 and 4 the q and out projections (B
    # operands n-major); the other bf16 bodies stage those two transposed
    # themselves. In bf16 k goes out split for the 3×TF32 logits (c8/8
    # k-steps × keys × 16 floats).
    bf16 = x.dtype == torch.bfloat16
    wk_t, wv_t = wk.t().contiguous(), wv.t().contiguous()
    wq_k, wo_k = ((wq.contiguous(), wo.contiguous())
                  if bf16 and BODIES[pl.body][0] < 3
                  else (wq.t().contiguous(), wo.t().contiguous()))
    k_shape = (n, c8 // 8, kvn, 16) if bf16 else (n, c8, kvn)
    k_t = torch.empty(k_shape, dtype=torch.float32, device=device)
    v_t = torch.empty((n, c2, kvn), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    err = lib.spatial_attn_kv(code, dev, x.data_ptr(), wk_t.data_ptr(),
                              wv_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
                              n, h, w, c, c8, c2, stream)
    _check(lib, err, "k/v")
    entry.launches += 1
    err = lib.spatial_attn_fwd(code, dev, x.data_ptr(), wq_k.data_ptr(),
                               wo_k.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
                               gamma.contiguous().data_ptr(), out.data_ptr(),
                               n, h, w, c, c8, c2, pl.body, pl.tq, pl.ctas,
                               stream)
    _check(lib, err, "attention")
    entry.launches += 1
    return out[..., :c - dc].contiguous() if dc else out


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
    """Without a graph to build nothing is saved. While `torch.export`
    traces it, the entry's registered op (`dvdgan::spatial_attn_fused`,
    `dvdgan::spatial_attn_tiled`; forward only)."""
    if torch.compiler.is_exporting():
        if entry is spatial_attn_tiled:
            return torch.ops.dvdgan.spatial_attn_tiled(*args, force_bqr)
        return torch.ops.dvdgan.spatial_attn_fused(*args)
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
