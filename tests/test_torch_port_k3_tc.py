"""The bf16 tensor-core body of K3 (`csrc/convgru_blocked.cu`), on the CPU:
its GEMM view of one fused GRU step and the plan that runs it.

One launch computes one time step. A CTA owns one batch element × a TH × TW
tile (`TILES` of the plan) with all C channels. `_fused_step_view` computes
the step the way the kernel indexes it, in f32, per tile of the plan:
stage A, the reset half of the gate conv over the (TH+2) × (TW+2) rim, from
the tile's (TH+4) × (TW+4) h patch (zero outside the plane: a halo never
reads the next frame), then r⊙h rounded to the activation type and zero
outside the plane; stage B per block of BN output channels, the update half
(A: the h patch shifted by one pixel) and the candidate (A: the r⊙h tile);
K = 9 taps × C in 16-channel chunks, chunk-major, each chunk's sum added to
the total. It is held to one step of the plain version
(`gru_sequence_reference`) at atol 1e-5 × max(1, max|ref|) in f32 (f32
sums in another order), 2e-2 in bf16 (a flipped rounding of r⊙h or of the
output: the CPU tests' bf16 bound for K3). The plan is held to what the
kernel needs at every K3 level of the driven presets. The kernel itself
runs only on a card (`tests/test_torch_port_gpu.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from dvdgan_tpu_torch.kernels import convgru_blocked as k3
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.ops import convgru

# (B, H, W, C) at test scale: channel counts that are not multiples of the
# mma tile (6, 12, 40, 72), planes smaller than a tile, ragged planes, a
# 1-pixel-tall and a 1-pixel-wide plane, and more than one channel block
SHAPES = [(2, 4, 4, 8), (3, 3, 5, 6), (2, 5, 6, 12), (3, 1, 5, 40),
          (2, 7, 1, 16), (2, 9, 17, 72), (1, 19, 11, 24), (1, 17, 18, 80)]


def _inputs(b, h, w, c, dtype, seed=0):
    """gx, cx, h0, wg, wc of one step as `dtype` tensors holding bf16
    values (the kernel's operands), from numpy."""
    rng = np.random.default_rng(seed)

    def bf16(*shape, s=1.0):
        a = s * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).bfloat16().to(dtype)

    scale = (9 * c) ** -0.5
    return (bf16(b, h, w, 2 * c), bf16(b, h, w, c),
            torch.tanh(bf16(b, h, w, c)).bfloat16().to(dtype),
            bf16(3, 3, c, 2 * c, s=scale), bf16(3, 3, c, c, s=scale))


def _gemm(rows, wt, kc):
    """sum over taps and chunks of rows[tap][:, chunk] @ wt[tap, chunk],
    each chunk's nine products summed first (the kernel's order)."""
    total = torch.zeros(rows[0].shape[0], wt.shape[-1])
    for lo in range(0, wt.shape[1], kc):
        ch = slice(lo, lo + kc)
        total += sum(rows[tap][:, ch] @ wt[tap, ch] for tap in range(9))
    return total


def _fused_step_view(gx, cx, h, wg, wc, tile: int):
    """One K3 step as the kernel forms it (see the module doc)."""
    dt = h.dtype
    b, hh, ww, c = h.shape
    th, tw, bn = k3.TILES[tile][:3]
    kc = k3.KC
    cpad = -(-c // kc) * kc
    h, gx, cx = h.float(), gx.float(), cx.float()

    def padded(wt, cols):            # (9, cpad, BN blocks): zero past C
        out = torch.zeros(9, cpad, -(-cols // bn) * bn)
        out[:, :c, :cols] = wt.float().reshape(9, c, cols)
        return out

    w_r, w_z, w_c = padded(wg[..., :c], c), padded(wg[..., c:], c), padded(
        wc, c)
    out = torch.full((b, hh, ww, c), float("nan"))
    for f in range(b):
        for y0 in range(0, hh, th):
            for x0 in range(0, ww, tw):
                # the h patch, (y0 - 2, x0 - 2) at its origin; gx on the rim
                patch = torch.zeros(th + 4, tw + 4, cpad)
                g_rim = torch.zeros(th + 2, tw + 2, c)
                for py in range(th + 4):
                    for px in range(tw + 4):
                        y, x = y0 - 2 + py, x0 - 2 + px
                        if 0 <= y < hh and 0 <= x < ww:
                            patch[py, px, :c] = h[f, y, x]
                            if 1 <= py <= th + 2 and 1 <= px <= tw + 2:
                                g_rim[py - 1, px - 1] = gx[f, y, x, :c]
                # stage A: the reset half on the rim, per channel block
                rows = [patch[dy:dy + th + 2, dx:dx + tw + 2].reshape(-1, cpad)
                        for dy in range(3) for dx in range(3)]
                sums = torch.cat([_gemm(rows, w_r[..., n:n + bn], kc)
                                  for n in range(0, w_r.shape[-1], bn)], -1)
                sums = sums[:, :c].reshape(th + 2, tw + 2, c)
                r = torch.sigmoid(g_rim + sums)
                rh = torch.zeros(th + 2, tw + 2, cpad)
                rh[..., :c] = (r * patch[1:th + 3, 1:tw + 3, :c]).to(dt)
                # stage B: update half and candidate per channel block
                rows_h = [patch[1 + dy:1 + dy + th, 1 + dx:1 + dx + tw]
                          .reshape(-1, cpad) for dy in range(3)
                          for dx in range(3)]
                rows_r = [rh[dy:dy + th, dx:dx + tw].reshape(-1, cpad)
                          for dy in range(3) for dx in range(3)]
                acc_z = torch.cat([_gemm(rows_h, w_z[..., n:n + bn], kc)
                                   for n in range(0, c, bn)], -1)
                acc_c = torch.cat([_gemm(rows_r, w_c[..., n:n + bn], kc)
                                   for n in range(0, c, bn)], -1)
                acc_z = acc_z[:, :c].reshape(th, tw, c)
                acc_c = acc_c[:, :c].reshape(th, tw, c)
                hy, wx = min(th, hh - y0), min(tw, ww - x0)
                sl = (f, slice(y0, y0 + hy), slice(x0, x0 + wx))
                z = torch.sigmoid(gx[sl][..., c:] + acc_z[:hy, :wx])
                cand = torch.tanh(cx[sl] + acc_c[:hy, :wx])
                h_prev = patch[2:2 + hy, 2:2 + wx, :c]
                out[sl] = ((1.0 - z) * h_prev + z * cand).to(dt).float()
    return out.to(dt)


def _ref_step(gx, cx, h, wg, wc):
    return k1.gru_sequence_reference(gx[None], cx[None], h, wg, wc)[0]


@pytest.mark.parametrize("tile", range(len(k3.TILES)))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_step_view_matches_the_plain_step(shape, tile):
    args = _inputs(*shape, torch.float32)
    ref = _ref_step(*args)
    got = _fused_step_view(*args, tile)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(2, 9, 17, 72), (3, 1, 5, 40)], ids=str)
def test_fused_step_view_in_bf16(shape):
    """bf16 activations: r⊙h and the output rounded where the kernel
    rounds them; every tile gives the plain step within the bf16 bound."""
    args = _inputs(*shape, torch.bfloat16, seed=1)
    ref = _ref_step(*args).float()
    for tile in range(len(k3.TILES)):
        got = _fused_step_view(*args, tile)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=2e-2)


def test_fused_step_view_tiles_agree():
    """The view under each tile, against the 8×8 tile's: the same sums in
    the same k order per element (the kernel's bits are the same; here f32
    matmuls of other sizes may round elsewhere)."""
    args = _inputs(2, 19, 23, 24, torch.float32, seed=2)
    first = _fused_step_view(*args, 0)
    for tile in range(1, len(k3.TILES)):
        torch.testing.assert_close(_fused_step_view(*args, tile), first,
                                   rtol=0, atol=1e-6)


def test_fused_step_view_halo_reads_no_neighbouring_frame():
    """An impulse at the edge of frame 0 leaves frame 1 (all zero state and
    inputs) at the plain step's value, under the tile that holds both
    frames' edges in one plane of tiles."""
    b, h, w, c = 2, 8, 8, 16
    gx, cx, h0, wg, wc = _inputs(b, h, w, c, torch.float32)
    gx[1], cx[1], h0[1] = 0.0, 0.0, 0.0
    h0[0, -1, -1] = 1.0
    out = _fused_step_view(gx, cx, h0, wg, wc, 0)
    torch.testing.assert_close(out[1], torch.zeros(h, w, c), rtol=0, atol=0)


def _smem(tile, c):
    """The kernel's shared memory, written out again: patch and r⊙h tile
    at a row stride of ceil16(C) + 8 bf16, three stages of 144 weight rows
    of BN + 8."""
    th, tw, bn = k3.TILES[tile][:3]
    ldh = -(-c // 16) * 16 + 8
    return (((th + 4) * (tw + 4) + (th + 2) * (tw + 2)) * ldh
            + 3 * 144 * (bn + 8)) * 2


def _k3_levels():
    """(B, H, W, C) of every K3 level of the driven presets at both of
    their batch sizes (`chip_smoke`'s level tables)."""
    out = [(b, h, w, c) for b in (chip_smoke.LONG_B, chip_smoke.LONG_B_FAKE)
           for h, w, c in chip_smoke.LONG_LEVELS]
    out += [(b, h, w, c) for b in (chip_smoke.PX128_B, chip_smoke.PX128_B_FAKE)
            for h, w, c in chip_smoke.PX128_LEVELS]
    return [s for s in out if convgru.uses_blocked(s[1], s[2])]


def test_plan_at_every_k3_level_of_the_driven_presets():
    levels = _k3_levels()
    assert sorted(levels) == sorted(
        [(2, 64, 64, 128), (2, 128, 128, 64), (8, 64, 64, 128),
         (8, 128, 128, 64), (8, 64, 64, 64), (16, 64, 64, 64)])
    for b, h, w, c in levels:
        p = k3.plan(b, h, w, c)
        th, tw = k3.TILES[p.tile][:2]
        assert p.smem_bytes <= k3.MAX_SMEM_BYTES, (b, h, w, c, p)
        assert p.smem_bytes == _smem(p.tile, c) == k3.smem_bytes(p.tile, c)
        assert p.ctas == b * -(-h // th) * -(-w // tw)
        # the largest tile that fills the card where one does, else the
        # one with most CTAs
        fits = [k3.plan(b, h, w, c, i) for i in range(len(k3.TILES))
                if _smem(i, c) <= k3.MAX_SMEM_BYTES]
        full = [q for q in fits if q.ctas >= k3.MIN_CTAS]
        if full:
            assert p.ctas >= k3.MIN_CTAS
            assert th * tw == max(k3.TILES[q.tile][0] * k3.TILES[q.tile][1]
                                  for q in full)
        else:
            assert p.ctas == max(q.ctas for q in fits)


@pytest.mark.parametrize("tile", range(len(k3.TILES)))
def test_forced_tile_and_the_shared_memory_limit(tile):
    p = k3.plan(2, 20, 20, 48, tile)
    assert p.tile == tile and p.smem_bytes == _smem(tile, 48)
    th, tw = k3.TILES[tile][:2]
    assert p.ctas == 2 * -(-20 // th) * -(-20 // tw)
    # the 8x8 tile holds C up to 336 in bf16; past it the plan's tile is
    # refused (the wrapper raises before it launches)
    assert k3.plan(1, 64, 64, 336).smem_bytes <= k3.MAX_SMEM_BYTES
    assert k3.plan(1, 64, 64, 352).smem_bytes > k3.MAX_SMEM_BYTES


def test_tile_table_maps_the_warps():
    """Eight warps: stage A's and stage B's rows along M divide them, each
    warp holds pairs of n-tiles, and stage B's M is whole m-tiles."""
    for th, tw, bn, wma, wmb in k3.TILES:
        assert k3.THREADS == 256 and 8 % wma == 0 and 8 % wmb == 0
        assert (th * tw) % 16 == 0
        for wm in (wma, wmb):
            n_tiles = bn // 8 // (8 // wm)       # a warp's n-tiles of 8
            assert n_tiles * 8 * (8 // wm) == bn and n_tiles % 2 == 0
    assert all(_smem(i, 64) <= k3.MAX_SMEM_BYTES
               for i in range(len(k3.TILES)))
