"""The weight layouts the K5a/K5b kernels read (`ups2x_fused.kernel_weights`),
on the CPU.

The bf16 tensor-core bodies of `csrc/ups2x_fused.cu` run three implicit
GEMMs whose B operand is n-major ([n][k], k contiguous); the f32 bodies read
the other layout. Each test below computes one launch's GEMM view in f32 the
way the kernel indexes it, from the operand `kernel_weights` hands that
launch, and holds it to the plain versions `ups2x_reference` /
`ups2x_bwd_reference` (atol 1e-5 × max(1, max|ref|): f32 sums in another
order). The kernels themselves run only on a card
(`tests/test_torch_port_gpu.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dvdgan_tpu_torch.kernels import ups2x_fused as k5

# (N, H, W, Cin, Cout): the GPU tests' edges at test scale, among them
# channel counts that are not multiples of the mma tile (Cin 24 and 40 of
# k 16, Cout 12 of n 8) and a plane smaller than a tile
SHAPES = [(2, 4, 4, 8, 4), (3, 3, 4, 5, 3), (2, 5, 7, 24, 12),
          (1, 9, 6, 40, 8), (2, 2, 3, 16, 20)]
TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _inputs(n, h, w, cin, cout, seed=0):
    """(wall, xp, g) as f32 tensors holding bf16 values (the kernel's
    operands), from numpy."""
    rng = np.random.default_rng(seed)

    def bf16(*shape, s=1.0):
        a = torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))
        return a.bfloat16().float()

    wall = bf16(4 * cin, 4 * cout, s=0.3)
    xp = torch.nn.functional.pad(bf16(n, h, w, cin), (0, 0, 1, 1, 1, 1))
    return wall, xp, bf16(n, 2 * h, 2 * w, cout)


def _close(got, ref):
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(ref.abs().max())))


def _bf16_operand(wall, launch):
    """The operand the bf16 kernel gets for `launch`, back in f32."""
    return k5.kernel_weights(wall.bfloat16(), launch).float()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k5a_gemm_view_of_wall_t(shape):
    """K5a per phase: out_pq[pix, co] = Σ_tap xp[pix + (p+a, q+b), :] ·
    B[phase·Cout + co, tap·Cin : (tap+1)·Cin]ᵀ, B n-major."""
    n, h, w, cin, cout = shape
    wall, xp, _ = _inputs(*shape)
    b = _bf16_operand(wall, "fwd")
    assert b.shape == (4 * cout, 4 * cin)
    out = torch.zeros(n, 2 * h, 2 * w, cout)
    for p in (0, 1):
        for q in (0, 1):
            ph = 2 * p + q
            acc = torch.zeros(n, h, w, cout)
            for tap, (a, bb) in enumerate(TAPS):
                x = xp[:, p + a:p + a + h, q + bb:q + bb + w, :]
                acc += x @ b[ph * cout:(ph + 1) * cout,
                             tap * cin:(tap + 1) * cin].t()
            out[:, p::2, q::2, :] = acc
    _close(out, k5.ups2x_reference(wall, xp))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k5b_dx_gemm_view_of_wall(shape):
    """K5b dxp: padded pixel (r, s) gathers g at (2r - dr, 2s - dc), dr, dc
    in 0..3 (phase dr & 1, tap dr >> 1, the same per column), times
    B[tap·Cin + ci, phase·Cout : (phase+1)·Cout]ᵀ, B n-major (wall)."""
    n, h, w, cin, cout = shape
    wall, xp, g = _inputs(*shape)
    b = _bf16_operand(wall, "dx")
    assert b.shape == (4 * cin, 4 * cout)
    gpad = torch.nn.functional.pad(g, (0, 0, 3, 3, 3, 3))
    dxp = torch.zeros(n, h + 2, w + 2, cin)
    for dr in range(4):
        for dc in range(4):
            ph = 2 * (dr & 1) + (dc & 1)
            tap = 2 * (dr >> 1) + (dc >> 1)
            a = gpad[:, 3 - dr::2, 3 - dc::2, :][:, :h + 2, :w + 2, :]
            dxp += a @ b[tap * cin:(tap + 1) * cin,
                         ph * cout:(ph + 1) * cout].t()
    _close(dxp, k5.ups2x_bwd_reference(wall, xp, g)[1])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k5b_dw_gemm_view_by_phase_and_slices(shape):
    """K5b dwall: one phase per block, M = ci, N = co, K = pixels of the
    (frame, tile) sequence cut into slices whose partial sums are added in
    slice order."""
    n, h, w, cin, cout = shape
    wall, xp, g = _inputs(*shape)
    dwall = torch.zeros(4 * cin, 4 * cout)
    for p in (0, 1):
        for q in (0, 1):
            ph = 2 * p + q
            gp = g[:, p::2, q::2, :].reshape(-1, cout)
            for tap, (a, bb) in enumerate(TAPS):
                x = xp[:, p + a:p + a + h, q + bb:q + bb + w, :]
                x = x.reshape(-1, cin)
                partials = [xs.t() @ gs for xs, gs in
                            zip(x.split(5), gp.split(5))]
                total = torch.zeros(cin, cout)
                for part in partials:
                    total += part
                dwall[tap * cin:(tap + 1) * cin, ph * cout:(ph + 1) * cout] = total
    _close(dwall, k5.ups2x_bwd_reference(wall, xp, g)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_hands_each_body_its_layout(dtype):
    wall = torch.arange(8 * 12, dtype=dtype).reshape(8, 12)
    fwd, dx = k5.kernel_weights(wall, "fwd"), k5.kernel_weights(wall, "dx")
    transposed, plain = (fwd, dx) if dtype == torch.bfloat16 else (dx, fwd)
    assert plain is wall
    assert transposed.is_contiguous() and torch.equal(transposed, wall.t())
