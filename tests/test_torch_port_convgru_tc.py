"""The bf16 tensor-core bodies of K1 and K2 (`csrc/conv3x3_mma.cuh`), on the
CPU: their GEMM views and the plan that runs them.

Each of the six bf16 launches (K1: gate, candidate; K2: gate, candidate,
drh, dh) is a SAME 3×3 conv as an implicit GEMM whose M is the step's
B·H·W pixels with the batch folded in. `_gemm_view` computes one launch the
way the kernel indexes it, in f32: per CTA pixel tile (frames × rows ×
columns of `MMA_TILES`) the (TH+2) × (TW+2) patch of each frame, zero
outside the plane (a halo never reads the next batch element); the weights
in the layout the wrapper hands that launch, HWIO as B's k-major rows; the
k-steps (one tap of a 16-channel chunk each, chunk-major) cut into the
plan's slices, each slice's sum added in slice order. It is held to the
plain versions' conv (`convgru_seq._conv3x3`) at atol 1e-5 ×
max(1, max|ref|): f32 sums in another order. The plan is held to what the
kernels need at every level of the driven presets. The kernels themselves
run only on a card (`tests/test_torch_port_gpu.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from dvdgan_tpu_torch.kernels import convgru_bwd as k2
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.kernels.convgru_blocked import MAX_SMEM_BYTES

# (B, H, W, C) at test scale: channel counts that are not multiples of the
# mma tile (6, 12, 40, 72), steps of 45 and 15 pixels, each tile
SHAPES = [(2, 4, 4, 8), (3, 3, 5, 6), (2, 5, 6, 12), (3, 1, 5, 40),
          (8, 8, 8, 12), (2, 9, 17, 72)]
# the six bf16 launches: (the plan's launch, the A operand, the weight
# layout the wrapper hands the kernel)
LAUNCHES = {"k1_gate": ("gate", "h", "wg"), "k1_cand": ("cand", "rh", "wc"),
            "k2_gate": ("gate", "h", "wg"), "k2_cand": ("cand", "rh", "wc"),
            "k2_drh": ("drh", "dcx", "wct"), "k2_dh": ("dh", "dgx", "wgt")}


def _operands(b, h, w, c, seed=0):
    """The A planes and weights of the six launches, as f32 tensors that
    hold bf16 values (the kernel's operands), from numpy."""
    rng = np.random.default_rng(seed)

    def bf16(*shape, s=1.0):
        a = torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))
        return a.bfloat16().float()

    wg, wc = bf16(3, 3, c, 2 * c, s=0.3), bf16(3, 3, c, c, s=0.3)
    return {"h": bf16(b, h, w, c), "rh": bf16(b, h, w, c),
            "dcx": bf16(b, h, w, c), "dgx": bf16(b, h, w, 2 * c), "wg": wg,
            "wc": wc, "wct": k2._flip_t(wc), "wgt": k2._flip_t(wg)}


def _gemm_view(src: torch.Tensor, wt: torch.Tensor, p: k1.Plan):
    """The launch's sums as the kernel forms them (see the module doc)."""
    b, h, w, cin = src.shape
    cout = wt.shape[-1]
    tf, th, tw, _, _ = k1.MMA_TILES[p.tile]
    kc = k1.MMA_KC
    kpad = p.ksteps // k1.TAPS * kc - cin       # channels past Cin: zero
    srcz = F.pad(src, (0, kpad))
    wz = F.pad(wt, (0, 0, 0, kpad)).reshape(k1.TAPS, -1, cout)
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    out = torch.full((b, h, w, cout), float("nan"))
    for mt in range(p.m_tiles):
        x0, y0 = mt % tiles_x * tw, mt // tiles_x % tiles_y * th
        f0 = mt // (tiles_x * tiles_y) * tf
        patch = torch.zeros(tf, th + 2, tw + 2, srcz.shape[-1])
        for f in range(tf):
            if f0 + f >= b:
                continue
            for yy in range(th + 2):
                for xx in range(tw + 2):
                    y, x = y0 + yy - 1, x0 + xx - 1
                    if 0 <= y < h and 0 <= x < w:
                        patch[f, yy, xx] = srcz[f0 + f, y, x]
        rows = [patch[:, dy:dy + th, dx:dx + tw].reshape(tf * th * tw, -1)
                for dy in range(3) for dx in range(3)]
        total = None
        for k_lo, k_hi in p.slice_bounds():
            part = torch.zeros(tf * th * tw, cout)
            for chunk in range(k_lo // k1.TAPS, (k_hi - 1) // k1.TAPS + 1):
                ch = slice(chunk * kc, (chunk + 1) * kc)
                taps = range(max(k_lo - chunk * k1.TAPS, 0),
                             min(k_hi - chunk * k1.TAPS, k1.TAPS))
                part += sum(rows[tap][:, ch] @ wz[tap, ch] for tap in taps)
            total = part if total is None else total + part
        sums = total.reshape(tf, th, tw, cout)
        for f in range(min(tf, b - f0)):
            hy, wx = min(th, h - y0), min(tw, w - x0)
            out[f0 + f, y0:y0 + hy, x0:x0 + wx] = sums[f, :hy, :wx]
    return out


@pytest.mark.parametrize("launch", list(LAUNCHES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gemm_view_matches_the_plain_conv(launch, shape):
    """Under the plan's slices, and under one slice and one k-step a slice
    (the sums cannot depend on the split beyond f32 order)."""
    name, a, wname = LAUNCHES[launch]
    ops = _operands(*shape)
    p = k1.plan(*shape, name)
    ref = k1._conv3x3(ops[a], ops[wname])
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    for slices in sorted({p.slices, 1, p.ksteps}):
        got = _gemm_view(ops[a], ops[wname], dataclasses.replace(
            p, slices=slices))
        torch.testing.assert_close(got, ref, rtol=0, atol=tol,
                                   msg=f"{launch} at {slices} slices")


def test_gemm_view_halo_reads_no_neighbouring_frame():
    """Two frames in one 4×4 tile: an impulse at the edge of frame 0 gives
    nothing in frame 1."""
    src = torch.zeros(2, 4, 4, 16)
    src[0, 3, 3] = 1.0
    wt = torch.ones(3, 3, 16, 8)
    out = _gemm_view(src, wt, k1.plan(2, 4, 4, 8, "cand"))
    assert k1.plan(2, 4, 4, 8, "cand").m_tiles == 1      # frames share a CTA
    assert float(out[1].abs().max()) == 0.0
    assert float(out[0, 2:, 2:].min()) == 16.0


def _driven_shapes():
    """(B, H, W, C) of every GRU level of the three driven presets at both
    of their batch sizes (`chip_smoke`'s level tables) and at test scale."""
    out = [(b, h, w, c) for b in (chip_smoke.B, chip_smoke.B_TRAIN)
           for h, w, c in chip_smoke.LEVELS]
    out += [(b, h, w, c) for b in (chip_smoke.LONG_B, chip_smoke.LONG_B_FAKE)
            for h, w, c in chip_smoke.LONG_LEVELS]
    out += [(b, h, w, c) for b in (chip_smoke.PX128_B, chip_smoke.PX128_B_FAKE)
            for h, w, c in chip_smoke.PX128_LEVELS]
    return out + SHAPES


@pytest.mark.parametrize("launch", list(k1.LAUNCH_CHANNELS))
def test_plan_fills_the_card_and_covers_k_once(launch):
    for shape in _driven_shapes():
        p = k1.plan(*shape, launch)
        b, h, w, c = shape
        tf, th, tw, bn, _ = k1.MMA_TILES[p.tile]
        cin, cout = (k * c for k in k1.LAUNCH_CHANNELS[launch])
        assert p.cout == cout and p.pixels == b * h * w
        assert p.m_tiles * tf * th * tw >= b * h * w      # every pixel
        assert p.n_blocks * bn >= cout
        assert p.ksteps == k1.TAPS * -(-cin // k1.MMA_KC)
        tiles = p.m_tiles * p.n_blocks
        if tiles < k1.MIN_CTAS:
            assert p.ctas >= k1.MIN_CTAS or p.slices == p.ksteps, (shape, p)
        else:
            assert p.slices == 1, (shape, p)
        if max(h, w) <= 8 and shape not in SHAPES:
            # the 4² and 8² levels of every driven shape fill the card
            assert p.ctas >= k1.MIN_CTAS, (shape, p)
        bounds = p.slice_bounds()
        assert bounds[0][0] == 0 and bounds[-1][1] == p.ksteps
        assert all(lo < hi for lo, hi in bounds)
        assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
        assert p.smem_bytes <= MAX_SMEM_BYTES
        # the kernel writes slice s's sum of pixel q, channel n at
        # (s·pixels + q)·cout + n, and uses one counter per tile
        assert p.work_floats == (p.slices * b * h * w * cout
                                 if p.slices > 1 else 0)
        assert p.counters == (tiles if p.slices > 1 else 0)


@pytest.mark.parametrize("shape", [(2, 4, 4, 512), (8, 8, 8, 256),
                                   (2, 32, 32, 256), (2, 4, 4, 8)], ids=str)
def test_workspace_is_sized_as_the_plans_need(shape):
    launches = ("gate", "cand", "drh", "dh")
    args, (work, counters) = k1.mma_args(*shape, launches, torch.bfloat16,
                                         torch.device("cpu"))
    plans = [k1.plan(*shape, name) for name in launches]
    assert work.numel() == max(p.work_floats for p in plans)
    assert counters.numel() == max(p.counters for p in plans)
    assert work.dtype == torch.float32 and not counters.any()
    for name, p in zip(launches, plans):
        assert args[name] == (p.tile, p.slices, work.data_ptr(),
                              counters.data_ptr())


def test_f32_takes_no_plan():
    args, keep = k1.mma_args(2, 4, 4, 8, ("gate", "cand"), torch.float32,
                             torch.device("cpu"))
    assert keep == () and set(args.values()) == {(0, 1, None, None)}


def test_large_planes_need_no_workspace():
    args, (work, counters) = k1.mma_args(2, 128, 128, 64, ("gate", "cand"),
                                         torch.bfloat16, torch.device("cpu"))
    assert work is None and counters is None
    assert all(a[1] == 1 for a in args.values())


def test_tile_table_fits_shared_memory():
    for tile, (tf, th, tw, bn, stages) in enumerate(k1.MMA_TILES):
        assert (tf * th * tw) % 32 == 0 and bn % 32 == 0 and stages >= 2
        smem = k1.mma_tile_smem(tile)
        assert smem <= MAX_SMEM_BYTES
        # the tile's f32 sums reuse the stages for the epilogue
        assert tf * th * tw * (bn + 4) * 4 <= smem
