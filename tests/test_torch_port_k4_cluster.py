"""The bf16 one-launch form of K4 (`csrc/convgru_cell.cu`,
`cell_cluster_kernel`), on the CPU: its cluster view of one GRU step and the
plan that runs it.

A thread-block cluster of K CTAs owns a batch element's plane; CTA j owns
the output channels S_j = [j·C/K, (j+1)·C/K). `_cluster_view` computes the
step the way the kernel indexes it: each CTA's plane buffer (the h plane,
channels zero past C up to whole 16-channel chunks, and a zero row that
every tap outside the plane points at), the gate conv for the columns r[S_j]
and z[S_j] only, r⊙h rounded to the activation type over h[S_j]; then the
exchange (the whole r⊙h plane, every slice gathered), the candidate conv for
S_j and the blend. Each conv is the kernel's contraction: K = 9 taps × C in
16-channel chunks, chunk-major, a chunk's nine taps summed first (exact
here: products of bf16 values summed in float64, as one rounding to f32
stands for the tensor cores' chunk sum), each chunk's sum added to the f32
total in chunk order. Nothing depends on K but which columns a CTA
computes, so the view has the same bits for every cluster size. It is held
to one step of the plain version (`gru_cell_reference`, which
`tests/test_torch_port_cell.py` holds to the interpreted Pallas K4) at atol
1e-5 × max(1, max|ref|) in f32 (sums in another order), 2e-2 in bf16 (a
flipped rounding of r⊙h or of the output). The kernel itself runs only on
a card (`tests/test_torch_port_gpu.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dvdgan_tpu_torch.kernels import convgru_cell as k4

KC = 16
# (B, H, W, C) at test scale: the plan's cluster sizes 1 (C 12, a ragged
# slice), 2, 3, 4, 5 and 8, planes of 4×4 and under (one m-tile) and over
# (four), ragged planes
SHAPES = [(2, 4, 4, 16), (2, 3, 3, 12), (1, 5, 7, 24), (2, 8, 8, 32),
          (2, 2, 6, 40), (1, 8, 8, 64)]
# the one-launch planes of the driven presets: ucf101_64 at B 16,
# kinetics_256_48f at B 2 (`chip_smoke.LEVELS`, `LONG_LEVELS`)
DRIVEN = [(16, 4, 4, 256), (16, 8, 8, 256), (2, 4, 4, 512), (2, 8, 8, 512)]


def _inputs(b, h, w, c, dtype, seed=0):
    """gx, cx, h, wg, wc of one step as `dtype` tensors holding bf16 values
    (the kernel's operands), from numpy; unit-gain 3×3 weights."""
    rng = np.random.default_rng(seed)

    def bf16(*shape, s=1.0):
        a = s * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).bfloat16().to(dtype)

    scale = (9 * c) ** -0.5
    return (bf16(b, h, w, 2 * c), bf16(b, h, w, c),
            torch.tanh(bf16(b, h, w, c)).bfloat16().to(dtype),
            bf16(3, 3, c, 2 * c, s=scale), bf16(3, 3, c, c, s=scale))


def _tap_rows(h, w):
    """(9, H·W) rows of the plane buffer each pixel's tap reads: the
    shifted pixel, or the zero row H·W outside the plane."""
    rows = torch.full((9, h * w), h * w, dtype=torch.long)
    for tap in range(9):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        for y in range(h):
            for x in range(w):
                if 0 <= y + dy < h and 0 <= x + dx < w:
                    rows[tap, y * w + x] = (y + dy) * w + x + dx
    return rows


def _conv(buf, wt, rows):
    """A CTA's implicit GEMM: buf (B, H·W + 1, cpad) f32, wt (9, cpad, N)
    -> (B, H·W, N) f32, chunk by chunk as the kernel sums."""
    total = torch.zeros(buf.shape[0], rows.shape[1], wt.shape[-1])
    for lo in range(0, wt.shape[1], KC):
        ch = slice(lo, lo + KC)
        part = sum(buf[:, rows[tap], ch].double() @ wt[tap, ch].double()
                   for tap in range(9))
        total += part.float()
    return total


def _cluster_view(gx, cx, h, wg, wc, k: int):
    """One K4 step as clusters of k CTAs form it (see the module doc)."""
    dt = h.dtype
    b, hh, ww, c = h.shape
    s, hw = c // k, hh * ww
    cpad = -(-c // KC) * KC
    rows = _tap_rows(hh, ww)
    gx, cx = gx.float().reshape(b, hw, 2 * c), cx.float().reshape(b, hw, c)
    hp = h.float().reshape(b, hw, c)

    def padded(wt, cols):                # (9, cpad, cols): zero past C
        out = torch.zeros(9, cpad, cols)
        out[:, :c] = wt.float().reshape(9, c, cols)
        return out

    w_g, w_c = padded(wg, 2 * c), padded(wc, c)
    plane = torch.zeros(b, hw + 1, cpad)            # every CTA stages it
    plane[:, :hw, :c] = hp
    rh = plane.clone()                              # after the exchange
    zs = []
    for j in range(k):
        cols = slice(j * s, (j + 1) * s)
        acc_r = _conv(plane, w_g[..., j * s:(j + 1) * s], rows)
        acc_z = _conv(plane, w_g[..., c + j * s:c + (j + 1) * s], rows)
        r = torch.sigmoid(gx[..., cols] + acc_r)
        zs.append(torch.sigmoid(gx[..., c + j * s:c + (j + 1) * s] + acc_z))
        rh[:, :hw, cols] = (r * hp[..., cols]).to(dt).float()
    out = torch.empty(b, hw, c)
    for j in range(k):
        cols = slice(j * s, (j + 1) * s)
        acc_c = _conv(rh, w_c[..., cols], rows)
        cand = torch.tanh(cx[..., cols] + acc_c)
        z = zs[j]
        out[..., cols] = ((1.0 - z) * hp[..., cols] + z * cand).to(dt).float()
    return out.reshape(b, hh, ww, c).to(dt)


def _planned(shape, dtype=torch.bfloat16):
    return k4.plan(dtype, *shape).cluster


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cluster_view_matches_the_plain_step(shape):
    args = _inputs(*shape, torch.float32)
    ref = k4.gru_cell_reference(*args)
    got = _cluster_view(*args, _planned(shape))
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(2, 5, 7, 24), (1, 8, 8, 64)], ids=str)
def test_cluster_view_in_bf16(shape):
    """bf16 activations: r⊙h and the output rounded where the kernel
    rounds them; within the bf16 bound of the plain step."""
    args = _inputs(*shape, torch.bfloat16, seed=1)
    ref = k4.gru_cell_reference(*args).float()
    got = _cluster_view(*args, _planned(shape))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=2e-2)


def test_cluster_view_has_the_same_bits_for_every_cluster_size():
    """Every cluster size that divides C (1 … 64 at C 64) gives the bits
    of one CTA a plane: an output's contraction does not depend on which
    CTA computes it."""
    args = _inputs(1, 8, 8, 64, torch.bfloat16, seed=2)
    one = _cluster_view(*args, 1)
    for k in (2, 4, 8, 16, 32, 64):
        assert torch.equal(_cluster_view(*args, k), one), k


def test_cluster_view_halo_reads_no_neighbouring_frame():
    """An impulse at the edge of batch element 0 leaves element 1 (all zero
    state and inputs) at the plain step's zero: each cluster's zero row
    pads its own plane."""
    b, h, w, c = 2, 4, 4, 16
    gx, cx, h0, wg, wc = _inputs(b, h, w, c, torch.float32)
    gx[1], cx[1], h0[1] = 0.0, 0.0, 0.0
    h0[0, -1, -1] = 1.0
    out = _cluster_view(gx, cx, h0, wg, wc, 2)
    torch.testing.assert_close(out[1], torch.zeros(h, w, c), rtol=0, atol=0)


def _smem(h, w, c, slice_):
    """The kernel's shared memory, written out again: the plane (H·W rows
    and a zero row of ceil16(C) + 8 bf16) and three weight stages of 144
    rows of 2 · (the slice in whole n-tile powers of two) + 8."""
    ntt = 1
    while 8 * ntt < slice_:
        ntt *= 2
    plane = (h * w + 1) * (-(-c // 16) * 16 + 8)
    return 2 * (plane + 3 * 144 * (16 * ntt + 8))


def test_plan_takes_the_driven_shapes_within_shared_memory():
    for b, h, w, c in DRIVEN:
        p = k4.plan(torch.bfloat16, b, h, w, c)
        assert (p.cluster, p.slice) == (8, c // 8), (b, h, w, c, p)
        assert p.smem_bytes == _smem(h, w, c, c // 8) <= k4.MAX_SMEM_BYTES
        assert p.tiles == (1 if h * w <= 16 else 4, c // 64)
        # 16 CTAs a cluster (non-portable) at the long clip's B 2
        q = k4.plan(torch.bfloat16, b, h, w, c, force_cluster=16)
        assert (q.cluster, q.slice) == (16, c // 16)
        assert q.smem_bytes == _smem(h, w, c, c // 16) <= k4.MAX_SMEM_BYTES
    assert sorted(k4.plan(torch.bfloat16, *s).cluster for s in SHAPES) == [
        1, 2, 3, 4, 5, 8]


def test_plan_refuses_what_it_cannot_hold():
    """Forced cluster sizes the kernel does not take raise before any
    launch; shapes no cluster size holds take K1's two launches (None)."""
    bf16 = torch.bfloat16
    for force in (3, 32, 64):     # not a divisor; over 16; 4-channel slices
        with pytest.raises(ValueError, match="does not take clusters"):
            k4.plan(bf16, 2, 8, 8, 256, force_cluster=force)
    with pytest.raises(ValueError, match="does not take clusters"):
        k4.plan(bf16, 2, 8, 8, 512, force_cluster=4)    # 128-channel slices
    with pytest.raises(ValueError, match="one CTA a plane"):
        k4.plan(torch.float32, 2, 8, 8, 256, force_cluster=8)
    # 1024 channels: 128-channel slices at 8, 252 KB a CTA at 16
    assert k4.plan(bf16, 1, 8, 8, 1024) is None
    with pytest.raises(ValueError, match="does not take clusters"):
        k4.plan(bf16, 1, 8, 8, 1024, force_cluster=16)
    # over the one-launch plane: K1's two launches, in either dtype
    for dtype in (bf16, torch.float32):
        assert k4.plan(dtype, 2, 9, 8, 64) is None
        assert k4.plan(dtype, 2, 16, 16, 256) is None
    # the f32 form: its CTA holds the whole plane in f32
    assert k4.plan(torch.float32, 2, 8, 8, 256).cluster == 1
    assert k4.plan(torch.float32, 1, 8, 8, 1024) is None


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args = _inputs(2, 4, 4, 16, torch.bfloat16, seed=3)
    before = k4.gru_cell_fused.launches
    out = k4.gru_cell_fused(*args)
    assert k4.gru_cell_fused.launches == before
    assert torch.equal(out, k4.gru_cell_reference(*args))
