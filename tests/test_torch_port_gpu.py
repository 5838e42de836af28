"""dvdgan_tpu_torch kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the paths through them (the
sample, K1's autograd.Function, one train step, the single-step GRU entry,
the fused upsample route, the fused attention route) on the card against
the CPU, and the trainer's batch placement and pinned checkpoints.
Marked `gpu`; each test skips (inside the `cuda` fixture) where there is
no CUDA device. Run them on a machine with one:
`python -m pytest tests/test_torch_port_gpu.py -q --noconftest`.

f32 with TF32 off: atol 1e-5 at these small shapes (1e-4 for whole paths
and for K2's weight gradients, sums over T·B·H·W terms). bf16: atol 2e-2
(the same bound as the CPU tests hold the plain version to against JAX),
relative to the largest reference value for K2's outputs; K6 in bf16: one
bf16 ulp at the output's scale.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import pytest
import torch

from dvdgan_tpu_torch import serving
from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.kernels import attention_spatial as k6
from dvdgan_tpu_torch.kernels import convgru_blocked as k3
from dvdgan_tpu_torch.kernels import convgru_bwd as k2
from dvdgan_tpu_torch.kernels import convgru_cell as k4
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.kernels import ups2x_fused as k5
from dvdgan_tpu_torch.models import (DSConfig, DTConfig, GConfig,
                                     generator)
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.ops import attention, convgru, layers
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _inputs(t, b, h, w, c, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g)).to(device, dtype)

    return (rand(t, b, h, w, 2 * c), rand(t, b, h, w, c),
            torch.tanh(rand(b, h, w, c)).contiguous(),
            rand(3, 3, c, 2 * c, s=0.1), rand(3, 3, c, c, s=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h,w,c", [(3, 2, 4, 4, 8),     # small-plane tile
                                       (3, 2, 5, 6, 8),     # ragged tiles
                                       (2, 3, 9, 17, 6),    # partial ch groups
                                       (2, 2, 16, 16, 40)])  # several ci chunks
def test_k1_kernel_matches_plain(cuda, dtype, t, b, h, w, c):
    args = _inputs(t, b, h, w, c, dtype, cuda)
    before = k1.gru_sequence_fused.launches
    out = k1.gru_sequence_fused(*args)
    torch.cuda.synchronize()
    assert k1.gru_sequence_fused.launches - before == (
        t * k1.LAUNCHES_PER_STEP)
    ref = k1.gru_sequence_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])


def test_k1_kernel_reads_strided_inputs(cuda):
    gx, cx, h0, wg, wc = _inputs(3, 2, 8, 8, 16, torch.float32, cuda)
    gcx = torch.cat([gx, cx], dim=-1)
    sliced = k1.gru_sequence_fused(gcx[..., :32], gcx[..., 32:], h0, wg, wc)
    bgx, bcx = (a[:1].expand(3, -1, -1, -1, -1) for a in (gx, cx))
    bcast = k1.gru_sequence_fused(bgx, bcx, h0, wg, wc)
    torch.cuda.synchronize()
    torch.testing.assert_close(sliced, k1.gru_sequence_reference(
        gx, cx, h0, wg, wc), rtol=0, atol=1e-5)
    torch.testing.assert_close(bcast, k1.gru_sequence_reference(
        bgx.contiguous(), bcx.contiguous(), h0, wg, wc), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        k1.gru_sequence_fused(gx, cx, h0, wg.transpose(0, 1), wc)
    with pytest.raises(TypeError, match="dtype"):
        k1.gru_sequence_fused(gx.half(), cx.half(), h0.half(), wg.half(),
                              wc.half())


def test_convgru_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    p = convgru.convgru_init(gen, 8)
    x = torch.randn(4, 2, 8, 8, 8, generator=gen)
    ref = convgru.convgru(p, x, time_major=True, x_static=False)
    dev = {k: {n: v.to(cuda) for n, v in d.items()} for k, d in p.items()}
    out = convgru.convgru(dev, x.to(cuda), time_major=True)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5)


def test_sample_on_card_matches_cpu(cuda):
    cfg = GConfig(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
                  emb_dim=16, attn_res=16)
    state = GeneratorState.create(cfg, seed=0)
    z = torch.randn(2, cfg.z_dim, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([1, 3])
    ref = step.sample(*state.trees(), z, y, cfg)
    before = k1.gru_sequence_fused.launches
    out = step.sample(*state.to(cuda).trees(), z.to(cuda), y.to(cuda), cfg)
    assert k1.gru_sequence_fused.launches - before == (
        cfg.n_levels * cfg.n_frames * k1.LAUNCHES_PER_STEP)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h,w,c", [(3, 2, 4, 4, 8),     # small-plane tile
                                       (3, 2, 5, 6, 8),     # ragged tiles
                                       (2, 3, 9, 17, 6),    # partial ch groups
                                       (2, 2, 16, 16, 40)])  # several ci chunks
def test_k2_kernel_matches_plain(cuda, dtype, t, b, h, w, c):
    args = _inputs(t, b, h, w, c, dtype, cuda)
    hs = k1.gru_sequence_fused(*args)
    g = torch.randn(hs.shape, generator=torch.Generator().manual_seed(9)
                    ).to(cuda, dtype)
    before = k2.gru_sequence_bwd.launches
    out = k2.gru_sequence_bwd(*args, hs, g)
    torch.cuda.synchronize()
    assert k2.gru_sequence_bwd.launches - before == t * k2.LAUNCHES_PER_STEP
    ref = k2.gru_sequence_bwd_reference(*args, hs, g)
    for name, o, r in zip(("dgx", "dcx", "dh0", "dwg", "dwc"), out, ref):
        assert o.dtype == dtype and o.shape == r.shape, name
        scale = 1.0 if dtype == torch.float32 else float(r.abs().max())
        atol = TOL[dtype] * (10 if name[:2] == "dw" and scale == 1.0
                             else scale)
        torch.testing.assert_close(o.float(), r.float(), rtol=0, atol=atol,
                                   msg=name)


def test_k2_kernel_reads_strided_inputs(cuda):
    gx, cx, h0, wg, wc = _inputs(3, 2, 8, 8, 16, torch.float32, cuda)
    hs = k1.gru_sequence_fused(gx, cx, h0, wg, wc)
    g = torch.randn_like(hs)
    gcx = torch.cat([gx, cx], dim=-1)
    sliced = k2.gru_sequence_bwd(gcx[..., :32], gcx[..., 32:], h0, wg, wc,
                                 hs, g)
    ref = k2.gru_sequence_bwd_reference(gx, cx, h0, wg, wc, hs, g)
    bgx, bcx = (a[:1].expand(3, -1, -1, -1, -1) for a in (gx, cx))
    hs_b = k1.gru_sequence_fused(bgx, bcx, h0, wg, wc)
    bcast = k2.gru_sequence_bwd(bgx, bcx, h0, wg, wc, hs_b, g)
    ref_b = k2.gru_sequence_bwd_reference(bgx.contiguous(), bcx.contiguous(),
                                          h0, wg, wc, hs_b, g)
    torch.cuda.synchronize()
    # dgx and dcx are dense whatever the layout of gx and cx
    assert all(o.is_contiguous() for o in (*sliced[:2], *bcast[:2]))
    for o, r, o_b, r_b in zip(sliced, ref, bcast, ref_b):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-4)
        torch.testing.assert_close(o_b, r_b, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        k2.gru_sequence_bwd(gx, cx, h0, wg, wc, hs, g.transpose(2, 3))


@pytest.mark.parametrize("x_static", [False, True])
def test_convgru_grads_on_card_match_cpu(cuda, x_static):
    """K1's autograd.Function (K1 forward, K2 backward) on the card against
    the plain versions on the CPU, through ops/convgru: the channel slices
    of the hoisted conv and, at x_static, their stride-0 broadcast."""
    gen = torch.Generator().manual_seed(0)
    p = convgru.convgru_init(gen, 8)
    x = torch.randn(4, 2, 8, 8, 8, generator=gen)
    up = torch.randn(4, 2, 8, 8, 8, generator=gen)

    def grads(p, x, up):
        leaves = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
                  for k, d in p.items()}
        x = x.clone().requires_grad_(True)
        hs = convgru.convgru(leaves, x, time_major=True, x_static=x_static)
        flat = [x] + [v for d in leaves.values() for v in d.values()]
        return [hs] + list(torch.autograd.grad((hs * up).sum(), flat))

    ref = grads(p, x, up)
    before = (k1.gru_sequence_fused.launches, k2.gru_sequence_bwd.launches)
    dev = {k: {n: v.to(cuda) for n, v in d.items()} for k, d in p.items()}
    out = grads(dev, x.to(cuda), up.to(cuda))
    assert (k1.gru_sequence_fused.launches - before[0],
            k2.gru_sequence_bwd.launches - before[1]) == (
        4 * k1.LAUNCHES_PER_STEP, 4 * k2.LAUNCHES_PER_STEP)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.cpu(), r, rtol=0, atol=1e-4)


def test_train_step_on_card_matches_cpu(cuda):
    g_cfg = GConfig(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
                    emb_dim=16, attn_res=16)
    ds_cfg = DSConfig(img_size=32, ch=8, n_classes=5, k_frames=2)
    dt_cfg = DTConfig(img_size=32, n_frames=4, ch=8, n_classes=5)
    tc = train_state.TrainConfig(d_steps=2, ema_start=0)
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    gen = torch.Generator().manual_seed(1)
    real = torch.tanh(torch.randn(2, 4, 32, 32, 3, generator=gen))
    y = torch.tensor([1, 3])
    z = {i: torch.randn(2, 120, generator=gen) for i in (0, 3, 6)}
    idx = {i: torch.rand(2, 4, generator=gen).argsort(dim=1)[:, :2]
           for i in (1, 2, 4, 5, 7)}

    class Replay:
        def __init__(self, device):
            self.device = device

        def z(self, i):
            return z[i].to(self.device)

        def idx(self, i):
            return idx[i].to(self.device)

    ref_state, ref_m = step.train_step(state, real, y, Replay("cpu"), g_cfg,
                                       ds_cfg, dt_cfg, tc)
    before = (k1.gru_sequence_fused.launches, k2.gru_sequence_bwd.launches)
    out_state, out_m = step.train_step(
        train_state.to_device(state, cuda), real.to(cuda), y.to(cuda),
        Replay(cuda), g_cfg, ds_cfg, dt_cfg, tc)
    n = g_cfg.n_levels * g_cfg.n_frames
    assert (k1.gru_sequence_fused.launches - before[0],
            k2.gru_sequence_bwd.launches - before[1]) == (
        2 * n * k1.LAUNCHES_PER_STEP, n * k2.LAUNCHES_PER_STEP)
    for k in ref_m:
        torch.testing.assert_close(out_m[k].cpu(), ref_m[k], rtol=0,
                                   atol=1e-4)
    for m in ("g", "ds", "dt"):      # mu is the gradient (β1 = 0)
        ref_mu = tree.flatten_with_paths(ref_state[m]["opt"]["mu"])
        out_mu = tree.flatten_with_paths(out_state[m]["opt"]["mu"])
        scale = max(float(v.abs().max()) for v in ref_mu.values())
        for k, r in ref_mu.items():
            torch.testing.assert_close(out_mu[k].cpu(), r, rtol=0,
                                       atol=1e-4 * scale, msg=f"{m} mu {k}")


# ---------------------------------------------------------------- K3 -------

def _forced_tile(monkeypatch, tile):
    """K3's plan with the bf16 tile `tile` forced (None: the plan's own)."""
    if tile is not None:
        monkeypatch.setattr(k3, "plan", functools.partial(k3.plan, tile=tile))


@pytest.mark.parametrize("tile", [None, *range(len(k3.TILES))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h,w,c", [(3, 2, 4, 4, 8),     # one ragged tile
                                       (3, 2, 5, 6, 8),     # ragged tile
                                       (2, 3, 9, 17, 6),    # partial ch groups
                                       (2, 2, 16, 16, 40),  # several ci chunks
                                       (2, 1, 24, 16, 72),  # > 1 oc block
                                       # rims across ragged edges of every
                                       # tile, a 1-pixel-wide plane
                                       (2, 2, 19, 23, 32),
                                       (2, 2, 13, 1, 16),
                                       # the long-clip path's 64² level
                                       # at more CTAs (192) than the card
                                       # has SMs: two share one
                                       (2, 3, 64, 64, 128)])
def test_k3_kernel_matches_plain(cuda, monkeypatch, tile, dtype, t, b, h, w,
                                 c):
    """Each bf16 tile forced (f32 has one body: its runs with a forced bf16
    tile repeat the plan's)."""
    if dtype == torch.bfloat16 and tile is not None and (
            k3.smem_bytes(tile, c) > k3.MAX_SMEM_BYTES):
        pytest.skip("the tile does not fit shared memory at this C")
    _forced_tile(monkeypatch, tile)
    args = _inputs(t, b, h, w, c, dtype, cuda)
    before = k3.gru_sequence_blocked.launches
    out = k3.gru_sequence_blocked(*args)
    torch.cuda.synchronize()
    assert k3.gru_sequence_blocked.launches - before == (
        t * k3.LAUNCHES_PER_STEP)
    ref = k3.gru_sequence_blocked_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])
    # K1 computes the same function on its own tiles
    torch.testing.assert_close(out.float(),
                               k1.gru_sequence_fused(*args).float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("t,b,h,w,c", [(3, 2, 19, 23, 32), (2, 2, 9, 17, 72),
                                       (2, 2, 64, 64, 64)])
def test_k3_bf16_has_the_same_bits_under_every_tile(cuda, monkeypatch, t, b,
                                                     h, w, c):
    """Two runs, and every tile of the plan: a rim pixel's r is its owner's
    bit for bit (the same k order per element), so the outputs are equal."""
    args = _inputs(t, b, h, w, c, torch.bfloat16, cuda, seed=3)
    first = k3.gru_sequence_blocked(*args)
    assert torch.equal(first, k3.gru_sequence_blocked(*args))
    plan = k3.plan
    for tile in range(len(k3.TILES)):
        if k3.smem_bytes(tile, c) > k3.MAX_SMEM_BYTES:
            continue
        monkeypatch.setattr(k3, "plan", functools.partial(plan, tile=tile))
        assert torch.equal(k3.gru_sequence_blocked(*args), first), tile


def test_k3_tile_table_matches_the_library(cuda):
    """The plan's copy of the tile table and shared-memory formula
    (`convgru_blocked.TILES`, `smem_bytes`) against the built kernel's."""
    for tile, dims in enumerate(k3.TILES):
        assert k3.tile_info(tile) == (*dims, k3.STAGES, k3.THREADS)
        for c in (6, 64, 72, 128, 256, 352):
            assert k3._lib().convgru_blocked_smem_bytes(1, c, tile) == (
                k3.smem_bytes(tile, c)), (tile, c)


def test_k3_kernel_reads_strided_inputs(cuda):
    gx, cx, h0, wg, wc = _inputs(3, 2, 16, 16, 16, torch.float32, cuda)
    gcx = torch.cat([gx, cx], dim=-1)
    sliced = k3.gru_sequence_blocked(gcx[..., :32], gcx[..., 32:], h0, wg, wc)
    bgx, bcx = (a[:1].expand(3, -1, -1, -1, -1) for a in (gx, cx))
    bcast = k3.gru_sequence_blocked(bgx, bcx, h0, wg, wc)
    torch.cuda.synchronize()
    torch.testing.assert_close(sliced, k3.gru_sequence_blocked_reference(
        gx, cx, h0, wg, wc), rtol=0, atol=1e-5)
    torch.testing.assert_close(bcast, k3.gru_sequence_blocked_reference(
        bgx.contiguous(), bcx.contiguous(), h0, wg, wc), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        k3.gru_sequence_blocked(gx, cx, h0.transpose(1, 2), wg, wc)
    with pytest.raises(TypeError, match="dtype"):
        k3.gru_sequence_blocked(gx.half(), cx.half(), h0.half(), wg.half(),
                                wc.half())


def test_k3_refuses_more_channels_than_shared_memory_holds(cuda):
    args = _inputs(1, 1, 8, 8, 512, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        k3.gru_sequence_blocked(*args)
    # bf16: the 8x8 tile holds C up to 336 (its patch and r⊙h tile at a row
    # stride of C + 8); one chunk more is refused before any launch
    before = k3.gru_sequence_blocked.launches
    args = _inputs(1, 1, 8, 8, 352, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        k3.gru_sequence_blocked(*args)
    assert k3.gru_sequence_blocked.launches == before
    args = _inputs(1, 1, 8, 8, 336, torch.bfloat16, cuda)
    out = k3.gru_sequence_blocked(*args)
    torch.testing.assert_close(
        out.float(), k3.gru_sequence_blocked_reference(*args).float(),
        rtol=0, atol=TOL[torch.bfloat16])


def test_convgru_large_plane_grads_on_card_match_cpu(cuda):
    """A plane over the K1/K3 boundary through ops/convgru: K3 forward and
    K2 backward on the card against the plain versions on the CPU."""
    c, hw = 20, 64
    assert convgru.uses_blocked(hw, hw)
    gen = torch.Generator().manual_seed(0)
    p = convgru.convgru_init(gen, c)
    x = torch.randn(2, 1, hw, hw, c, generator=gen)
    up = torch.randn(2, 1, hw, hw, c, generator=gen)

    def grads(p, x, up):
        leaves = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
                  for k, d in p.items()}
        x = x.clone().requires_grad_(True)
        hs = convgru.convgru(leaves, x, time_major=True)
        flat = [x] + [v for d in leaves.values() for v in d.values()]
        return [hs] + list(torch.autograd.grad((hs * up).sum(), flat))

    ref = grads(p, x, up)
    before = (k1.gru_sequence_fused.launches, k2.gru_sequence_bwd.launches,
              k3.gru_sequence_blocked.launches)
    dev = {k: {n: v.to(cuda) for n, v in d.items()} for k, d in p.items()}
    out = grads(dev, x.to(cuda), up.to(cuda))
    assert (k1.gru_sequence_fused.launches - before[0],
            k2.gru_sequence_bwd.launches - before[1],
            k3.gru_sequence_blocked.launches - before[2]) == (
        0, 2 * k2.LAUNCHES_PER_STEP, 2 * k3.LAUNCHES_PER_STEP)
    for o, r in zip(out, ref):
        scale = max(1.0, float(r.detach().abs().max()))
        torch.testing.assert_close(o.cpu(), r, rtol=0, atol=1e-4 * scale)


def _accum_case():
    """A 128 px step at a width the CPU takes: (configs, state, real, y,
    draws by stream). Its last GRU level, a 64² plane, goes to K3."""
    g_cfg = GConfig(img_size=128, n_frames=2, ch=12, z_dim=120, n_classes=5,
                    emb_dim=16, attn_res=16, remat=True)
    ds_cfg = DSConfig(img_size=128, ch=8, n_classes=5, k_frames=2)
    dt_cfg = DTConfig(img_size=128, n_frames=2, ch=8, n_classes=5)
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    gen = torch.Generator().manual_seed(1)
    real = torch.tanh(torch.randn(2, 2, 128, 128, 3, generator=gen))
    y = torch.tensor([1, 3])
    z = {i: torch.randn(2, 120, generator=gen) for i in (0, 3)}
    idx = {i: torch.rand(2, 2, generator=gen).argsort(dim=1)[:, :2]
           for i in (1, 2, 4)}
    return (g_cfg, ds_cfg, dt_cfg), state, real, y, z, idx


def _run_step(case, device, grad_accum=2, remat=True):
    (g_cfg, ds_cfg, dt_cfg), state, real, y, z, idx = case

    class Replay:
        def z(self, i):
            return z[i].to(device)

        def idx(self, i):
            return idx[i].to(device)

    tc = train_state.TrainConfig(d_steps=1, ema_start=0,
                                 grad_accum=grad_accum)
    return step.train_step(
        train_state.to_device(state, device), real.to(device), y.to(device),
        Replay(), dataclasses.replace(g_cfg, remat=remat), ds_cfg, dt_cfg,
        tc)


def _mu_gap(out, ref) -> dict:
    """Per model, the largest |Adam mu difference| over max|mu| (mu is the
    gradient: β1 = 0), and the leaf it is at."""
    gaps = {}
    for m in ("g", "ds", "dt"):
        ref_mu = tree.flatten_with_paths(ref[0][m]["opt"]["mu"])
        out_mu = tree.flatten_with_paths(out[0][m]["opt"]["mu"])
        scale = max(float(v.abs().max()) for v in ref_mu.values())
        err = {k: float((out_mu[k].cpu() - r.cpu()).abs().max()) / scale
               for k, r in ref_mu.items()}
        worst = max(err, key=err.get)
        gaps[m] = (err[worst], worst)
    return gaps


def test_accum_remat_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One step with grad_accum=2 and remat at a width whose last level
    goes to K3, card against CPU; the backward reruns no sequence kernel.

    The card is held twice. Against itself: the same step with every plane
    sent to K1 and remat off differs only by K3's f32 summation order
    (remat changes no value): 2.0e-6 × max|mu| measured on an H100, held
    at 1e-5. Against the CPU at 6e-4 × max|mu|, twice the 3.0e-4 measured
    (G's first layer, `seed/w`; DS 9.7e-6, DT 4.0e-7). That gap is f32
    summation order and not this step's accumulation, remat or K3: two
    witnesses are printed beside it. The step without any of the three
    reads 1.1e-4 card against CPU at the same leaf; and the CPU against
    itself with its convolutions summed in another order (oneDNN off) reads
    4.0–4.3e-4 for this step and 1.1–1.2e-4 for the plain one. Accumulation
    triples the gap on either pair of devices because G's BN then takes
    its moments over one clip, not two."""
    case = _accum_case()
    g_cfg = case[0][0]
    planes = [g_cfg.base_res * 2 ** i for i in range(g_cfg.n_levels)]
    n_k3 = sum(convgru.uses_blocked(r, r) for r in planes)
    assert n_k3 == 1
    ref = _run_step(case, "cpu")
    before = (k1.gru_sequence_fused.launches, k2.gru_sequence_bwd.launches,
              k3.gru_sequence_blocked.launches)
    out = _run_step(case, cuda)
    t, n, ka = g_cfg.n_frames, g_cfg.n_levels, 2
    assert (k1.gru_sequence_fused.launches - before[0],
            k2.gru_sequence_bwd.launches - before[1],
            k3.gru_sequence_blocked.launches - before[2]) == (
        (n - n_k3) * t * (1 + ka) * k1.LAUNCHES_PER_STEP,
        n * t * ka * k2.LAUNCHES_PER_STEP,
        n_k3 * t * (1 + ka) * k3.LAUNCHES_PER_STEP)
    for k in ref[1]:
        torch.testing.assert_close(out[1][k].cpu(), ref[1][k], rtol=0,
                                   atol=1e-4)

    # the witnesses: K1 everywhere and no remat on the card; and the step
    # without accumulation, remat or K3 on both
    plain_ref = _run_step(case, "cpu", grad_accum=1, remat=False)
    monkeypatch.setattr(convgru, "uses_blocked", lambda h, w: False)
    before = k3.gru_sequence_blocked.launches
    k1_out = _run_step(case, cuda, remat=False)
    plain_out = _run_step(case, cuda, grad_accum=1, remat=False)
    assert k3.gru_sequence_blocked.launches == before
    gaps = {"card vs cpu": _mu_gap(out, ref),
            "card vs card with K1, no remat": _mu_gap(out, k1_out),
            "plain, card vs cpu": _mu_gap(plain_out, plain_ref)}
    with torch.backends.mkldnn.flags(enabled=False):
        gaps["cpu vs cpu without oneDNN"] = _mu_gap(
            _run_step(case, "cpu"), ref)
        gaps["plain, cpu vs cpu without oneDNN"] = _mu_gap(
            _run_step(case, "cpu", grad_accum=1, remat=False), plain_ref)
    print("\nmu gaps over max|mu|:", gaps)
    for m, (err, leaf) in gaps["card vs card with K1, no remat"].items():
        assert err <= 1e-5, f"{m} mu {leaf}: {err:.3e}"
    for m, (err, leaf) in gaps["card vs cpu"].items():
        assert err <= 6e-4, f"{m} mu {leaf}: {err:.3e}"


def test_remat_on_card_keeps_upsample_outputs_and_sequences(cuda):
    """G forward + backward with remat on the card: the gradients are the
    plain ones, the upsample conv (the one 2×2 kernel) runs once per level
    (its output is kept, not recomputed) while 3×3 convs of the blocks are
    recomputed, and no sequence kernel reruns."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ConvCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                k = tuple(args[1].shape[-2:])
                self.n[k] = self.n.get(k, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = GConfig(img_size=128, n_frames=2, ch=12, z_dim=120, n_classes=5,
                  emb_dim=16, attn_res=16)
    gen = torch.Generator().manual_seed(0)
    params, stats = generator.init(gen, cfg)
    params = tree.tree_map(
        lambda p: (p + 0.05 * torch.randn(p.shape, generator=gen)).to(cuda),
        params)
    stats = tree.tree_map(lambda s: s.to(cuda), stats)
    z = torch.randn(2, cfg.z_dim, generator=gen).to(cuda)
    y = torch.tensor([1, 3]).to(cuda)

    def run(cfg):
        leaves = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        flat = tree.flatten_with_paths(leaves)
        before = (k1.gru_sequence_fused.launches
                  + k3.gru_sequence_blocked.launches)
        with ConvCount() as convs:
            video, _ = generator.apply(leaves, stats, z, y, cfg, train=True)
            grads = torch.autograd.grad((video ** 2).mean(),
                                        list(flat.values()))
        launched = (k1.gru_sequence_fused.launches
                    + k3.gru_sequence_blocked.launches - before)
        return dict(zip(flat, grads)), convs.n, launched

    plain = run(cfg)
    remat = run(dataclasses.replace(cfg, remat=True))
    n_k3 = sum(convgru.uses_blocked(cfg.base_res * 2 ** i,
                                    cfg.base_res * 2 ** i)
               for i in range(cfg.n_levels))
    assert plain[2] == remat[2] == cfg.n_frames * (
        (cfg.n_levels - n_k3) * k1.LAUNCHES_PER_STEP
        + n_k3 * k3.LAUNCHES_PER_STEP)
    assert plain[1][(2, 2)] == remat[1][(2, 2)] == cfg.n_levels
    assert remat[1][(3, 3)] > plain[1][(3, 3)]
    scale = max(float(g.abs().max()) for g in plain[0].values())
    worst = max(float((g - remat[0][k]).abs().max())
                for k, g in plain[0].items()) / scale
    print("\nremat vs plain on the card, over max|grad|:", worst)
    assert worst <= 2e-6     # 3.9e-7 measured on an H100


# ------------------------------------------- K1, K2 on the tensor cores ---

def _unit_inputs(t, b, h, w, c, device, seed=0):
    """bf16 K1 inputs with unit-gain 3×3 weights (the scale SN leaves), so
    that the gates stay off saturation at the production widths."""
    g = torch.Generator().manual_seed(seed)
    s = (9 * c) ** -0.5

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(device,
                                                            torch.bfloat16)

    return (rand(t, b, h, w, 2 * c), rand(t, b, h, w, c),
            torch.tanh(rand(b, h, w, c)).contiguous(),
            rand(3, 3, c, 2 * c, scale=s), rand(3, 3, c, c, scale=s))


# (T, B, H, W, C): the long-clip widths at 4², 8² (split K) and 32² (8×16
# tiles), B 1 and 3, channel counts that are not multiples of the mma
# tile (6, 12, 40, 72), a step of 15 pixels, two 8×8 frames a CTA (B·H·W
# ≥ 512)
TC_SHAPES = [(3, 2, 4, 4, 512), (3, 2, 8, 8, 512), (3, 2, 32, 32, 256),
             (3, 1, 4, 4, 512), (3, 3, 8, 8, 512), (3, 2, 5, 6, 6),
             (3, 3, 1, 5, 12), (2, 3, 9, 17, 40), (2, 2, 8, 8, 72),
             (2, 8, 8, 8, 64)]


@pytest.mark.parametrize("t,b,h,w,c", TC_SHAPES)
def test_k1_tensor_cores_match_plain_and_repeat_bitwise(cuda, t, b, h, w, c):
    args = _unit_inputs(t, b, h, w, c, cuda)
    before = k1.gru_sequence_fused.launches
    out = k1.gru_sequence_fused(*args)
    again = k1.gru_sequence_fused(*args)
    torch.cuda.synchronize()
    assert k1.gru_sequence_fused.launches - before == (
        2 * t * k1.LAUNCHES_PER_STEP)
    assert torch.equal(out, again)          # partial sums in a fixed order
    ref = k1.gru_sequence_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("t,b,h,w,c", TC_SHAPES + [(2, 2, 128, 128, 64)])
def test_k2_tensor_cores_match_plain_and_repeat_bitwise(cuda, t, b, h, w, c):
    args = _unit_inputs(t, b, h, w, c, cuda)
    hs = k1.gru_sequence_fused(*args)
    g = torch.randn(hs.shape, generator=torch.Generator().manual_seed(9)
                    ).to(cuda, torch.bfloat16)
    before = k2.gru_sequence_bwd.launches
    out = k2.gru_sequence_bwd(*args, hs, g)
    again = k2.gru_sequence_bwd(*args, hs, g)
    torch.cuda.synchronize()
    assert k2.gru_sequence_bwd.launches - before == (
        2 * t * k2.LAUNCHES_PER_STEP)
    ref = k2.gru_sequence_bwd_reference(*args, hs, g)
    for name, o, a, r in zip(("dgx", "dcx", "dh0", "dwg", "dwc"), out, again,
                             ref):
        if name[:2] != "dw":   # the kernel's own outputs; dW are cuDNN's
            assert torch.equal(o, a), name
        torch.testing.assert_close(
            o.float(), r.float(), rtol=0,
            atol=TOL[torch.bfloat16] * float(r.float().abs().max()), msg=name)


def test_mma_tiles_match_the_library(cuda):
    """The plan's copy of the tile table (`convgru_seq.MMA_TILES`, its
    shared memory) is the one the kernels were built with."""
    for tile, dims in enumerate(k1.MMA_TILES):
        assert k1.mma_tile_info(tile) == (*dims, k1.mma_tile_smem(tile))


# ---------------------------------------------------------------- K4 -------

# the one-launch planes of the driven presets (ucf101_64 at B 16,
# kinetics_256_48f at B 2): bf16 clusters of 8 CTAs
K4_DRIVEN = [(16, 4, 4, 256), (16, 8, 8, 256), (2, 4, 4, 512), (2, 8, 8, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,launches", [
    (2, 4, 4, 8, 1),      # the 4x4 plane tile
    (3, 5, 7, 12, 1),     # a ragged plane in the 8x8 tile, partial groups
    (2, 8, 8, 72, 1),     # > 1 output-channel block, several ci chunks
    (2, 9, 17, 6, 2),     # over the one-launch tile: gate + candidate
    (1, 32, 32, 40, 2)] + [(*s, 1) for s in K4_DRIVEN])
def test_k4_kernel_matches_plain(cuda, dtype, b, h, w, c, launches):
    gx, cx, h0, wg, wc = _inputs(1, b, h, w, c, dtype, cuda)
    args = (gx[0], cx[0], h0, wg, wc)
    before = k4.gru_cell_fused.launches
    out = k4.gru_cell_fused(*args)
    torch.cuda.synchronize()
    assert k4.gru_cell_fused.launches - before == launches
    ref = k4.gru_cell_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])
    step = k1.gru_sequence_fused(gx, cx, h0, wg, wc)[0]
    if dtype == torch.float32 or launches == 2:
        # K1's step sums in the same order and blends with the same
        # roundings (two launches: K4 runs K1's own)
        assert torch.equal(out, step)
    else:
        # the bf16 cluster form sums in K1's chunk order, but K1 cuts the
        # contraction of these small planes into slices (split K) and adds
        # their partial sums: another order
        torch.testing.assert_close(out.float(), step.float(), rtol=0,
                                   atol=TOL[dtype])




@pytest.mark.parametrize("b,h,w,c", K4_DRIVEN + [(3, 5, 7, 64), (2, 8, 8, 72)])
def test_k4_bf16_has_the_same_bits_under_every_cluster_size(cuda, monkeypatch,
                                                            b, h, w, c):
    """Each output's contraction runs in one order whatever CTA of whatever
    cluster computes it: every cluster size the kernel takes (of 1 … 16;
    over 8 is non-portable) gives the plan's bits, one launch a call, and a
    second run the same bits."""
    gx, cx, h0, wg, wc = _unit_inputs(1, b, h, w, c, cuda, seed=4)
    args = (gx[0], cx[0], h0, wg, wc)
    own = k4.gru_cell_fused(*args)
    assert torch.equal(k4.gru_cell_fused(*args), own)
    plan, sizes = k4.plan, []
    for k in range(1, k4.MAX_CLUSTER + 1):
        try:
            plan(torch.bfloat16, b, h, w, c, force_cluster=k)
        except ValueError:
            continue
        sizes.append(k)
        monkeypatch.setattr(k4, "plan",
                            functools.partial(plan, force_cluster=k))
        before = k4.gru_cell_fused.launches
        out = k4.gru_cell_fused(*args)
        torch.cuda.synchronize()
        assert k4.gru_cell_fused.launches - before == 1
        assert torch.equal(out, own), k
    print(f"\n{(b, h, w, c)}: the same bits under clusters of {sizes}")
    assert len(sizes) >= 2


@pytest.mark.parametrize("b,h,w,c", [(2, 8, 8, 64), (2, 4, 4, 256)])
def test_k4_cluster_reads_strided_inputs(cuda, b, h, w, c):
    """gx and cx as channel slices of one (B, H, W, 3C) tensor (the hoisted
    input conv's output): the bits of contiguous copies."""
    gx, cx, h0, wg, wc = _unit_inputs(1, b, h, w, c, cuda, seed=5)
    gcx = torch.cat([gx[0], cx[0]], dim=-1)
    out = k4.gru_cell_fused(gcx[..., :2 * c], gcx[..., 2 * c:], h0, wg, wc)
    torch.cuda.synchronize()
    assert torch.equal(out, k4.gru_cell_fused(gx[0], cx[0], h0, wg, wc))
    torch.testing.assert_close(out.float(), k4.gru_cell_reference(
        gx[0], cx[0], h0, wg, wc).float(), rtol=0, atol=TOL[torch.bfloat16])


def test_k4_plan_matches_the_library(cuda):
    """`k4.plan`'s shared memory and GEMM tiles are the kernel's, for every
    cluster size it takes; the sizes it refuses the kernel refuses."""
    lib = k4._lib()
    out = (ctypes.c_int * 2)()
    for b, h, w, c in K4_DRIVEN + [(2, 3, 3, 12), (1, 5, 7, 24),
                                   (2, 8, 8, 72)]:
        f32 = k4.plan(torch.float32, b, h, w, c)
        assert lib.convgru_cell_plane_smem_bytes(h, w, c) == f32.smem_bytes
        for k in range(1, 17):
            smem = lib.convgru_cell_cluster_smem_bytes(h, w, c, k,
                                                       ctypes.addressof(out))
            tiles = k4.cluster_tiles(h, w, c, k)
            if tiles is None:
                assert smem == 0, (b, h, w, c, k)
                continue
            assert (smem, tuple(out)) == (
                k4.cluster_smem_bytes(h, w, c, tiles[1]), tiles)


def test_k4_bf16_takes_two_launches_where_no_cluster_holds_the_plane(cuda):
    """1024 channels: 128-channel slices at 8 CTAs, 252 KB a CTA at 16: the
    entry takes K1's gate + candidate pair, with K1's bits."""
    gx, cx, h0, wg, wc = _unit_inputs(1, 1, 8, 8, 1024, cuda)
    before = k4.gru_cell_fused.launches
    out = k4.gru_cell_fused(gx[0], cx[0], h0, wg, wc)
    torch.cuda.synchronize()
    assert k4.gru_cell_fused.launches - before == 2
    assert torch.equal(out, k1.gru_sequence_fused(gx, cx, h0, wg, wc)[0])


def test_k4_kernel_reads_strided_inputs(cuda):
    for h in (8, 16):       # one launch; gate + candidate
        gx, cx, h0, wg, wc = _inputs(1, 2, h, h, 16, torch.float32, cuda)
        gcx = torch.cat([gx[0], cx[0]], dim=-1)
        out = k4.gru_cell_fused(gcx[..., :32], gcx[..., 32:], h0, wg, wc)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, k4.gru_cell_reference(
            gx[0], cx[0], h0, wg, wc), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        k4.gru_cell_fused(gx[0], cx[0], h0.transpose(1, 2), wg, wc)
    with pytest.raises(TypeError, match="dtype"):
        k4.gru_cell_fused(gx[0].half(), cx[0].half(), h0.half(), wg.half(),
                          wc.half())


def test_k4_takes_two_launches_where_shared_memory_is_short(cuda):
    """An 8x8 plane of 1024 f32 channels (262 KB of r*h) is over a CTA's
    227 KB: the entry takes the gate + candidate pair, not another route."""
    gx, cx, h0, wg, wc = _inputs(1, 1, 8, 8, 1024, torch.float32, cuda)
    before = k4.gru_cell_fused.launches
    out = k4.gru_cell_fused(gx[0], cx[0], h0, wg, wc)
    torch.cuda.synchronize()
    assert k4.gru_cell_fused.launches - before == 2
    torch.testing.assert_close(out, k4.gru_cell_reference(
        gx[0], cx[0], h0, wg, wc), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [8, 16])
def test_convgru_cell_grads_on_card_match_cpu(cuda, hw):
    """K4 forward and K2 (T = 1) backward on the card, through
    ops/convgru.convgru_cell, against the plain versions on the CPU."""
    gen = torch.Generator().manual_seed(0)
    p = convgru.convgru_init(gen, 8)
    x = torch.randn(2, hw, hw, 8, generator=gen)
    h = torch.randn(2, hw, hw, 8, generator=gen)
    up = torch.randn(2, hw, hw, 8, generator=gen)

    def grads(p, x, h, up):
        leaves = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
                  for k, d in p.items()}
        x, h = x.clone().requires_grad_(True), h.clone().requires_grad_(True)
        out = convgru.convgru_cell(leaves, x, h)
        flat = [x, h] + [v for d in leaves.values() for v in d.values()]
        return [out] + list(torch.autograd.grad((out * up).sum(), flat))

    ref = grads(p, x, h, up)
    before = (k4.gru_cell_fused.launches, k2.gru_sequence_bwd.launches)
    dev = {k: {n: v.to(cuda) for n, v in d.items()} for k, d in p.items()}
    out = grads(dev, x.to(cuda), h.to(cuda), up.to(cuda))
    assert (k4.gru_cell_fused.launches - before[0],
            k2.gru_sequence_bwd.launches - before[1]) == (
        1 if hw <= k4.PLANE_MAX else 2, k2.LAUNCHES_PER_STEP)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.cpu(), r, rtol=0, atol=1e-4)


# ---------------------------------------------------------- K5a, K5b -------

def _ups_inputs(n, h, w, cin, cout, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    # wide levels: unit-gain phase kernels, so |out| stays below 8, where
    # K5a's bf16 bound (4e-2) is one ulp
    scale = 0.3 if cin <= 40 else (4 * cin) ** -0.5
    wall = (scale * torch.randn(4 * cin, 4 * cout, generator=g)).to(device,
                                                                     dtype)
    x = torch.randn(n, h, w, cin, generator=g).to(device, dtype)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)).contiguous()
    up = torch.randn(n, 2 * h, 2 * w, cout, generator=g).to(device, dtype)
    return wall, xp, up


UPS_SHAPES = [(3, 4, 4, 8, 4),       # the 4x4 tile, a ragged frame group
              (11, 3, 4, 5, 3),      # odd channels: no whole chunk or group
              (3, 5, 7, 12, 20),     # H != W, the two-frame tile
              (2, 9, 17, 6, 36),     # ragged 8x16 tiles, 2 channel blocks
              (2, 16, 24, 40, 8),    # several Cin chunks, 2 blocks of ci
              # tensor-core edges: Cin 24 and 40 are not multiples of the
              # mma's k (16), Cout 12 not of its n (8); Cin and Cout above
              # one CTA's block (dwall: 64 ci x 32 co; K5a 32 co, dxp 32 ci)
              (3, 5, 6, 24, 12),
              (2, 8, 10, 40, 16),
              (2, 12, 20, 72, 40),
              (4, 4, 4, 512, 512),   # the long clip's 4x4 512->512 level
              (2, 128, 128, 64, 32)]  # and its 128x128 64->32 level


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", UPS_SHAPES)
def test_k5a_kernel_matches_plain(cuda, dtype, n, h, w, cin, cout):
    wall, xp, _ = _ups_inputs(n, h, w, cin, cout, dtype, cuda)
    before = k5.ups2x.launches
    out = k5.ups2x(wall, xp)
    torch.cuda.synchronize()
    assert k5.ups2x.launches - before == k5.LAUNCHES_PER_CALL
    ref = k5.ups2x_reference(wall, xp)
    assert out.dtype == dtype and out.shape == ref.shape
    # bf16: one ulp at |out| < 8
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 4e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", UPS_SHAPES)
def test_k5b_kernel_matches_plain_and_repeats_bitwise(cuda, dtype, n, h, w,
                                                      cin, cout):
    wall, xp, up = _ups_inputs(n, h, w, cin, cout, dtype, cuda)
    before = k5.ups2x_bwd.launches
    out = k5.ups2x_bwd(wall, xp, up)
    torch.cuda.synchronize()
    assert k5.ups2x_bwd.launches - before == k5.BWD_LAUNCHES_PER_CALL
    again = k5.ups2x_bwd(wall, xp, up)
    ref = k5.ups2x_bwd_reference(wall, xp, up)
    for name, o, a, r in zip(("dwall", "dxp"), out, again, ref):
        assert o.dtype == torch.float32 and o.shape == r.shape, name
        assert torch.equal(o, a), name      # fixed-order reduction
        torch.testing.assert_close(o, r, rtol=0, msg=name,
                                   atol=1e-5 * max(1.0, float(r.abs().max())))


def test_k5b_many_slices_repeat_bitwise(cuda):
    """A long reduction (many frames, one block of channels: the bf16
    dwall launch splits it over ~100 slices) gives the same bits twice."""
    wall, xp, up = _ups_inputs(64, 32, 32, 16, 8, torch.bfloat16, cuda)
    first = k5.ups2x_bwd(wall, xp, up)
    second = k5.ups2x_bwd(wall, xp, up)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    ref = k5.ups2x_bwd_reference(wall, xp, up)
    for o, r in zip(first, ref):
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))


def test_ups2x_refuses_what_the_kernel_does_not_take(cuda):
    wall, xp, up = _ups_inputs(2, 4, 4, 8, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k5.ups2x(wall.t().contiguous().t(), xp)
    with pytest.raises(TypeError, match="dtype"):
        k5.ups2x(wall.half(), xp.half())
    with pytest.raises(TypeError, match="dtype"):
        k5.ups2x(wall.bfloat16(), xp)
    with pytest.raises(ValueError, match="several devices"):
        k5.ups2x(wall.cpu(), xp)
    with pytest.raises(ValueError, match="contiguous"):
        k5.ups2x_bwd(wall, xp, up.transpose(1, 2))


@pytest.mark.parametrize("mode", ["fwd", "full"])
def test_upsample_layer_fused_on_card_matches_cpu(cuda, mode):
    """`upsample2x_conv3x3(fused=mode)` on the card (K5a; K5b under "full")
    against the CPU's plain versions, values and gradients."""
    gen = torch.Generator().manual_seed(0)
    p = {"w": 0.2 * torch.randn(3, 3, 12, 20, generator=gen),
         "b": 0.1 * torch.randn(20, generator=gen)}
    x = torch.randn(3, 9, 17, 12, generator=gen)
    up = torch.randn(3, 18, 34, 20, generator=gen)

    def run(device):
        leaves = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        xx = x.to(device).requires_grad_(True)
        out = layers.upsample2x_conv3x3(leaves, xx, mode)
        return [out] + list(torch.autograd.grad(
            (out * up.to(device)).sum(), (leaves["w"], leaves["b"], xx)))

    ref = run("cpu")
    before = (k5.ups2x.launches, k5.ups2x_bwd.launches)
    out = run(cuda)
    assert (k5.ups2x.launches - before[0],
            k5.ups2x_bwd.launches - before[1]) == (
        1, k5.BWD_LAUNCHES_PER_CALL if mode == "full" else 0)
    for o, r in zip(out, ref):
        o, r = o.detach().cpu(), r.detach()
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-5 * max(1.0, float(r.abs().max())))


def test_remat_with_fused_route_on_card_launches_k5a_once_per_level(cuda):
    """G forward + backward with remat and `ups_fused="full"` on the card:
    K5a launches once per level (none from the backward), K5b once per
    level, and the gradients are the plain forward's."""
    cfg = GConfig(img_size=128, n_frames=2, ch=12, z_dim=120, n_classes=5,
                  emb_dim=16, attn_res=16, ups_fused="full")
    gen = torch.Generator().manual_seed(0)
    params, stats = generator.init(gen, cfg)
    params = tree.tree_map(
        lambda p: (p + 0.05 * torch.randn(p.shape, generator=gen)).to(cuda),
        params)
    stats = tree.tree_map(lambda s: s.to(cuda), stats)
    z = torch.randn(2, cfg.z_dim, generator=gen).to(cuda)
    y = torch.tensor([1, 3]).to(cuda)

    def run(cfg, device=cuda):
        leaves = tree.tree_map(
            lambda p: p.detach().to(device).requires_grad_(True), params)
        flat = tree.flatten_with_paths(leaves)
        before = (k5.ups2x.launches, k5.ups2x_bwd.launches)
        video, new_stats = generator.apply(
            leaves, tree.tree_map(lambda s: s.to(device), stats),
            z.to(device), y.to(device), cfg, train=True)
        fwd = k5.ups2x.launches - before[0]
        grads = torch.autograd.grad((video ** 2).mean(), list(flat.values()))
        return (dict(zip(flat, grads)), tree.flatten_with_paths(new_stats),
                fwd, k5.ups2x.launches - before[0],
                k5.ups2x_bwd.launches - before[1])

    plain = run(cfg)
    remat = run(dataclasses.replace(cfg, remat=True))
    for r in (plain, remat):
        assert r[2] == r[3] == cfg.n_levels * k5.LAUNCHES_PER_CALL
        assert r[4] == cfg.n_levels * k5.BWD_LAUNCHES_PER_CALL
    for k, s in plain[1].items():
        assert torch.equal(s, remat[1][k]), k
    scale = max(float(g.abs().max()) for g in plain[0].values())
    worst = max(float((g - remat[0][k]).abs().max())
                for k, g in plain[0].items()) / scale
    print("\nremat vs plain with the fused route, over max|grad|:", worst)
    assert worst <= 2e-6
    # and the route changes no value beyond f32 summation order: 4.4e-4
    # measured on an H100, at the deepest leaf (seed/w), where the unfused
    # route on the card against itself on the CPU reads 7.5e-4 and the two
    # routes on the CPU 2.4e-4 (printed beside it as witnesses)
    off_cfg = dataclasses.replace(cfg, ups_fused="off")
    off = run(off_cfg)
    assert off[3] == off[4] == 0

    def gap(a, b):
        return max(float((g.cpu() - b[0][k].cpu()).abs().max())
                   for k, g in a[0].items()) / scale

    print("full vs off on the card, over max|grad|:", gap(plain, off))
    off_cpu = run(off_cfg, "cpu")
    print("off, card vs CPU:", gap(off, off_cpu))
    print("full vs off on the CPU:", gap(run(cfg, "cpu"), off_cpu))
    assert gap(plain, off) <= 1.5e-3


def test_train_step_fused_on_card_matches_cpu(cuda):
    g_cfg = GConfig(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
                    emb_dim=16, attn_res=16, ups_fused="full")
    ds_cfg = DSConfig(img_size=32, ch=8, n_classes=5, k_frames=2)
    dt_cfg = DTConfig(img_size=32, n_frames=4, ch=8, n_classes=5)
    tc = train_state.TrainConfig(d_steps=2, ema_start=0)
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    gen = torch.Generator().manual_seed(1)
    real = torch.tanh(torch.randn(2, 4, 32, 32, 3, generator=gen))
    y = torch.tensor([1, 3])
    z = {i: torch.randn(2, 120, generator=gen) for i in (0, 3, 6)}
    idx = {i: torch.rand(2, 4, generator=gen).argsort(dim=1)[:, :2]
           for i in (1, 2, 4, 5, 7)}

    class Replay:
        def __init__(self, device):
            self.device = device

        def z(self, i):
            return z[i].to(self.device)

        def idx(self, i):
            return idx[i].to(self.device)

    ref_state, ref_m = step.train_step(state, real, y, Replay("cpu"), g_cfg,
                                       ds_cfg, dt_cfg, tc)
    before = (k5.ups2x.launches, k5.ups2x_bwd.launches)
    out_state, out_m = step.train_step(
        train_state.to_device(state, cuda), real.to(cuda), y.to(cuda),
        Replay(cuda), g_cfg, ds_cfg, dt_cfg, tc)
    # the fake pass and the G forward; the G backward
    assert (k5.ups2x.launches - before[0],
            k5.ups2x_bwd.launches - before[1]) == (
        2 * g_cfg.n_levels, g_cfg.n_levels * k5.BWD_LAUNCHES_PER_CALL)
    for k in ref_m:
        torch.testing.assert_close(out_m[k].cpu(), ref_m[k], rtol=0,
                                   atol=1e-4)
    for m, (err, leaf) in _mu_gap((out_state,), (ref_state,)).items():
        assert err <= 1e-4, f"{m} mu {leaf}: {err:.3e}"


def test_fp_train_step_on_card_matches_cpu(cuda):
    """DVD-GAN-FP (cond_frames 2, 4 generated frames) at test scale, f32,
    d_steps 1: the card against the CPU from the same state and draws, K1
    and K2 launched for the warm-up and the generation at every level (K2's
    dh0 feeding the warm-up's K2)."""
    g_cfg = GConfig(img_size=32, n_frames=4, ch=8, z_dim=120, n_classes=5,
                    emb_dim=16, attn_res=16, cond_frames=2)
    ds_cfg = DSConfig(img_size=32, ch=8, n_classes=5, k_frames=2)
    dt_cfg = DTConfig(img_size=32, n_frames=6, ch=8, n_classes=5)
    tc = train_state.TrainConfig(d_steps=1, ema_start=0)
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    gen = torch.Generator().manual_seed(1)
    real = torch.tanh(torch.randn(2, 6, 32, 32, 3, generator=gen))
    y = torch.tensor([1, 3])
    z = {i: torch.randn(2, 120, generator=gen) for i in (0, 3)}
    idx = {i: torch.rand(2, 4, generator=gen).argsort(dim=1)[:, :2]
           for i in (1, 2, 4)}

    class Replay:
        def __init__(self, device):
            self.device = device

        def z(self, i):
            return z[i].to(self.device)

        def idx(self, i):
            return idx[i].to(self.device)

    ref_state, ref_m = step.train_step(state, real, y, Replay("cpu"), g_cfg,
                                       ds_cfg, dt_cfg, tc)
    before = (k1.gru_sequence_fused.launches, k2.gru_sequence_bwd.launches)
    out_state, out_m = step.train_step(
        train_state.to_device(state, cuda), real.to(cuda), y.to(cuda),
        Replay(cuda), g_cfg, ds_cfg, dt_cfg, tc)
    steps = g_cfg.n_levels * (g_cfg.cond_frames + g_cfg.n_frames)
    # the fake pass and the G forward; the G backward
    assert (k1.gru_sequence_fused.launches - before[0],
            k2.gru_sequence_bwd.launches - before[1]) == (
        2 * steps * k1.LAUNCHES_PER_STEP, steps * k2.LAUNCHES_PER_STEP)
    for k in ref_m:
        torch.testing.assert_close(out_m[k].cpu(), ref_m[k], rtol=0,
                                   atol=1e-4)
    gaps = _mu_gap((out_state,), (ref_state,))
    print("\nFP, card vs CPU: " + ", ".join(
        f"{m} {err:.3e} at {leaf}" for m, (err, leaf) in gaps.items()))
    for m, (err, leaf) in gaps.items():
        assert err <= 1e-4, f"{m} mu {leaf}: {err:.3e}"
    enc = tree.flatten_with_paths(out_state["g"]["opt"]["mu"]["fp_enc"])
    assert all(float(v.abs().max()) > 0 for v in enc.values())


# ------------------------------------------- the fused spatial attention ---

def _attn_inputs(n, h, w, c, dtype, device, seed=0, gamma=0.7):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return (shape[0] ** -0.5 * torch.randn(shape, generator=gen)
                ).to(device, dtype)

    x = torch.randn(n, h, w, c, generator=gen).to(device, dtype)
    return (x, rand(c, c // 8), rand(c, c // 8), rand(c, c // 2),
            rand(c // 2, c), torch.tensor(gamma, device=device))


def _attn_entry(h, w):
    return (k6.spatial_attn_tiled if attention.uses_tiled(h, w)
            else k6.spatial_attn_fused)


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


ATTN_SHAPES = [(256, 32, 32, 64), (128, 32, 32, 64),    # ucf101_64
               (384, 32, 32, 256), (96, 32, 32, 256),   # kinetics_256_48f
               (192, 64, 64, 64), (96, 64, 64, 64),     # 128 px, attn 64
               (3, 16, 8, 64),      # a wide map, 32 keys: a 64-query tile
               (2, 8, 8, 128),      # 16 keys: half a warp's softmax step
               (2, 24, 24, 64),     # 576 queries, 144 keys: a 64-query tile
               # the bf16 sweep bodies at each width, a ragged last block
               (2, 48, 48, 128),    # 576 keys, c2 64
               (2, 40, 40, 64),     # 400 keys: 6 blocks of 64 and 16 more
               (2, 16, 16, 256),    # 64 keys, c2 128
               # bf16: k and vᵀ read from L2 (mode 2)
               (2, 64, 64, 128),    # kinetics_256_48f with --attn_res 64
               (1, 64, 64, 256)]
# bf16: the wide body (mode 3): the 8² attention of the 128 and 256 px
# presets at C 512 (c8 64, c2 256; `--attn_res 8`) and 16² at C 384 (c8 48,
# c2 192)
WIDE_SHAPES = [(2, 8, 8, 512), (2, 16, 16, 384)]
# every shape the reference's kernels take: the 4² map (4 keys, padded to
# 16, the padded logits masked) in mode 1 (C 128) and mode 3 (C 512, 2048);
# c8 ∉ 8ℕ (C 32: c8 4; C 96: c8 12; zero-padded weights); bf16 C % 32 ==
# 16 (x padded); the wide widths on small maps in more passes (mode 3:
# 16²×768, 8²×1536) and on larger ones (mode 4: 32²×384 at the
# `--ch 96` attention, 32²×1024, 64²×384 of 256 px at ch 96)
DOMAIN_SHAPES = [(3, 4, 4, 128), (4, 4, 4, 256), (4, 4, 4, 512),
                 (2, 4, 4, 2048), (2, 32, 32, 32), (2, 32, 32, 96),
                 (2, 16, 16, 80), (2, 16, 16, 768), (2, 8, 8, 1536),
                 (4, 32, 32, 384), (2, 32, 32, 1024), (1, 64, 64, 384)]
# the wide bodies' ragged tiles: 24² (144 keys: a last k tile of 16 keys and
# v^T tile of 16), 28×36 (252 keys padded to 256: mode 4's logits kept in
# registers with 4 keys masked), 12² at C 768 (36 keys padded to 48: mode
# 3's second k tile of 16 keys, 4 masked)
WIDE_EDGE_SHAPES = [(2, 24, 24, 384), (2, 28, 36, 384), (2, 12, 12, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", ATTN_SHAPES + WIDE_SHAPES
                         + DOMAIN_SHAPES + WIDE_EDGE_SHAPES)
def test_k6_kernel_matches_plain(cuda, dtype, n, h, w, c):
    args = _attn_inputs(n, h, w, c, dtype, cuda, seed=n + c)
    entry = _attn_entry(h, w)
    before = entry.launches
    out = entry(*args)
    torch.cuda.synchronize()
    assert entry.launches - before == k6.LAUNCHES_PER_CALL
    ref = k6.spatial_attn_kernel_reference(*args)
    assert out.shape == ref.shape and out.dtype == dtype
    scale = float(ref.float().abs().max())
    atol = 1e-4 if dtype == torch.float32 else _bf16_ulp(scale)
    plan = k6.plan(dtype, n, h, w, c, c // 8, c // 2)
    print(f"\n{(n, h, w, c)} {dtype} {plan}: {int((out != ref).sum())} of "
          f"{out.numel()} elements differ, max "
          f"{float((out.float() - ref.float()).abs().max()):.3e} "
          f"(limit {atol:.3e})")
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)
    # γ = 0: x back bit for bit
    zero = entry(*args[:5], torch.zeros_like(args[5]))
    assert torch.equal(zero, args[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_forced_tiles_compute_the_same_function(cuda, dtype):
    """Every query tile force_bqr gives computes the plain version's
    function; in bf16 (a warp per 16 queries, whatever the tile) with the
    same bits as the kernel's own plan."""
    args = _attn_inputs(4, 32, 32, 64, dtype, cuda, seed=1)
    ref = k6.spatial_attn_kernel_reference(*args).float()
    atol = 1e-4 if dtype == torch.float32 else _bf16_ulp(float(ref.abs().max()))
    own = k6.spatial_attn_tiled(*args)
    for bqr in (1, 2) + ((4,) if dtype == torch.bfloat16 else ()):
        out = k6.spatial_attn_tiled(*args, force_bqr=bqr)  # 32, 64, 128
        torch.testing.assert_close(out.float(), ref, rtol=0, atol=atol)
        if dtype == torch.bfloat16:
            assert torch.equal(out, own), bqr
    with pytest.raises(ValueError, match="does not take"):
        k6.spatial_attn_tiled(*args, force_bqr=32)      # 1024 queries: no fit
    small = _attn_inputs(2, 8, 8, 64, dtype, cuda, seed=2)
    with pytest.raises(ValueError, match="does not take"):
        k6.spatial_attn_tiled(*small, force_bqr=1)      # 8 queries: not 16·k
    with pytest.raises(ValueError, match="does not divide H"):
        k6.spatial_attn_tiled(*small, force_bqr=3)


# one shape per bf16 body (`k6.BODIES`): 32² with C 64 and 256 (logits in
# registers), 64²×64, 48²×128 and 16²×256 (key sweeps), 96²×64, 64²×128
# and 64²×256 (key sweeps from L2), 8²×512 and 16²×384 (the wide body),
# 32²×384 and 64²×384 (the wide sweep)
BODY_SHAPES = [(4, 32, 32, 64), (3, 32, 32, 256), (2, 64, 64, 64),
               (2, 48, 48, 128), (4, 16, 16, 256), (2, 96, 96, 64),
               (2, 64, 64, 128), (1, 64, 64, 256), (3, 8, 8, 512),
               (2, 16, 16, 384), (3, 32, 32, 384), (1, 64, 64, 384)]


# the wide bodies at the four wide calls of `--ch 96` (64²×384 and 32²×384 in
# mode 4, 16²×768 and 8²×1536 in mode 3) at N 8: work items whose warps
# share the ring's tiles, several items a CTA at the plan's grid
WIDE_PLAN_SHAPES = [(8, 64, 64, 384), (8, 32, 32, 384), (8, 16, 16, 768),
                    (8, 8, 8, 1536)]


def _k6_tiles(n, h, w, c):
    """The query tiles the bf16 plan takes when forced."""
    out = []
    for tq in (16, 32, 64, 128, 256):
        try:
            k6.plan(torch.bfloat16, n, h, w, c, c // 8, c // 2, force_tq=tq)
        except ValueError:
            continue
        out.append(tq)
    return out


@pytest.mark.parametrize("n,h,w,c", BODY_SHAPES + WIDE_PLAN_SHAPES
                         + [(8, 24, 24, 384)])
def test_k6_bf16_has_the_same_bits_under_every_plan(cuda, monkeypatch, n, h,
                                                    w, c):
    """A query's output does not depend on the work item's size, on the
    persistent grid, or on the run: every query tile the body takes and
    grids of 1, 5 and the plan's CTAs give the bits of the plan's own run."""
    args = _attn_inputs(n, h, w, c, torch.bfloat16, cuda, seed=5)
    own = k6.spatial_attn_fused(*args)
    assert torch.equal(k6.spatial_attn_fused(*args), own)        # two runs
    plan = k6.plan
    tiles = _k6_tiles(n, h, w, c)
    assert len(tiles) >= 3
    for tq in tiles:
        for ctas in (1, 5, None):
            monkeypatch.setattr(k6, "plan", lambda *a, tq=tq, ctas=ctas, **kw:
                                plan(*a, **{**kw, "force_tq": tq,
                                            "ctas": ctas}))
            assert torch.equal(k6.spatial_attn_fused(*args), own), (tq, ctas)
    monkeypatch.setattr(k6, "plan", plan)


@pytest.mark.parametrize("n,h,w,c", [s for s in DOMAIN_SHAPES
                                     if s[1] * s[2] < 32 * 32])
def test_k6_bf16_small_maps_have_the_same_bits_under_every_plan(
        cuda, monkeypatch, n, h, w, c):
    """The padded 4² map (masked keys) and the wide body in more passes:
    two runs, every tile the plan takes and grids of 1, 2 and the plan's
    give the same bits."""
    args = _attn_inputs(n, h, w, c, torch.bfloat16, cuda, seed=8)
    own = k6.spatial_attn_fused(*args)
    assert torch.equal(k6.spatial_attn_fused(*args), own)
    plan = k6.plan
    tiles = _k6_tiles(n, h, w, c)
    assert tiles
    for tq in tiles:
        for ctas in (1, 2, None):
            monkeypatch.setattr(k6, "plan", lambda *a, tq=tq, ctas=ctas, **kw:
                                plan(*a, **{**kw, "force_tq": tq,
                                            "ctas": ctas}))
            assert torch.equal(k6.spatial_attn_fused(*args), own), (tq, ctas)
    monkeypatch.setattr(k6, "plan", plan)


@pytest.mark.parametrize("n,h,w,c", BODY_SHAPES[2:5])
def test_k6_bf16_l2_body_has_the_bits_of_the_staged_body(cuda, monkeypatch,
                                                         n, h, w, c):
    """Mode 2 (k and vᵀ read from L2) runs mode 1's instructions on the
    same values: at a shape both take, the same bits."""
    args = _attn_inputs(n, h, w, c, torch.bfloat16, cuda, seed=6)
    own = k6.spatial_attn_fused(*args)
    plan = k6.plan
    staged = plan(torch.bfloat16, n, h, w, c, c // 8, c // 2)
    mode, ot, warps = k6.BODIES[staged.body]
    assert mode == 1
    l2 = k6.BODIES.index((2, ot, warps))
    monkeypatch.setattr(k6, "plan", lambda *a, **kw: dataclasses.replace(
        plan(*a, **kw), body=l2))
    assert torch.equal(k6.spatial_attn_fused(*args), own)
    monkeypatch.setattr(k6, "plan", plan)


@pytest.mark.parametrize("n,h,w,c,c8,c2", [
    (2, 16, 16, 80, 16, 32),      # C % 32 == 16: no model width (c8 = C/8)
    (2, 32, 32, 384, 48, 192)])   # C 384 on a map of more than 64 keys
def test_k6_bf16_refuses_what_its_bodies_do_not_hold(cuda, n, h, w, c, c8,
                                                     c2):
    """What the bf16 bodies once refused they now take (C % 32 == 16
    through a zero-padded copy of x, C 384 on 256 keys in the wide sweep):
    within one ulp of the plain version, as the f32 body is within 1e-4.
    What they still refuse is a forced tile that does not fit, with no
    launch."""
    gen = torch.Generator().manual_seed(7)
    args = [torch.randn(n, h, w, c, generator=gen)] + [
        a ** -0.5 * torch.randn(a, b, generator=gen)
        for a, b in ((c, c8), (c, c8), (c, c2), (c2, c))]
    args = [a.to(cuda, torch.bfloat16) for a in args] + [
        torch.tensor(0.7, device=cuda)]
    entry = _attn_entry(h, w)
    before = entry.launches
    out = entry(*args)
    assert entry.launches - before == k6.LAUNCHES_PER_CALL
    ref = k6.spatial_attn_kernel_reference(*args).float()
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=_bf16_ulp(float(ref.abs().max())))
    with pytest.raises(ValueError, match="does not take"):
        k6.spatial_attn_tiled(*args, force_bqr=h)      # H·W queries: no fit
    assert entry.launches - before == k6.LAUNCHES_PER_CALL
    f32 = [a.float() for a in args]
    out = entry(*f32)
    torch.testing.assert_close(out, k6.spatial_attn_kernel_reference(*f32),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,h,w,c", ATTN_SHAPES[:6] + ATTN_SHAPES[-2:]
                         + WIDE_SHAPES + [(96, 8, 8, 512), (192, 8, 8, 512)]
                         + DOMAIN_SHAPES + WIDE_PLAN_SHAPES
                         + WIDE_EDGE_SHAPES)
def test_k6_bf16_differs_from_plain_on_at_most_half_a_percent(cuda, n, h, w,
                                                              c):
    """At the driven calls the bf16 kernel's output differs from the plain
    version's (f32 sums in another order, tensor-core accumulation, 3×TF32
    logits, ex2.approx) on at most 0.5% of the elements, each by one ulp at
    the output's scale (`test_k6_kernel_matches_plain`)."""
    args = _attn_inputs(n, h, w, c, torch.bfloat16, cuda, seed=n + c)
    out = _attn_entry(h, w)(*args)
    ref = k6.spatial_attn_kernel_reference(*args)
    share = float((out != ref).float().mean())
    print(f"\n{(n, h, w, c)}: {share:.4%} of the elements differ")
    assert share <= 0.005


@pytest.mark.parametrize("n,h,w,c", [(96, 64, 64, 64), (2, 64, 64, 128)])
def test_k6_bf16_differ_share_holds_over_seeds(cuda, n, h, w, c):
    """The 64² sweep sums attn·v over all keys in one accumulator chain:
    the share of differing elements, the largest over eight seeds, stays
    within 0.5%."""
    shares = []
    for seed in range(8):
        args = _attn_inputs(n, h, w, c, torch.bfloat16, cuda, seed=100 + seed)
        out = _attn_entry(h, w)(*args)
        ref = k6.spatial_attn_kernel_reference(*args)
        shares.append(float((out != ref).float().mean()))
        del args, out, ref
    print(f"\n{(n, h, w, c)}: differing share over 8 seeds, max "
          f"{max(shares):.4%}, mean {sum(shares) / 8:.4%}")
    assert max(shares) <= 0.005


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_plan_matches_the_kernel(cuda, dtype):
    """`k6.plan`'s shared-memory formula and body table are the kernel's;
    the kernel takes every plan it makes and refuses what it refuses."""
    lib, code = k6._lib(), k6._DTYPE_CODES[dtype]
    for i, row in enumerate(k6.BODIES):
        out = (ctypes.c_int * 3)()
        assert lib.spatial_attn_body(i, ctypes.addressof(out)) == 0
        assert tuple(out) == row
    assert lib.spatial_attn_body(len(k6.BODIES), ctypes.addressof(out)) != 0
    for n, h, w, c in ATTN_SHAPES + BODY_SHAPES + DOMAIN_SHAPES:
        plan = k6.plan(dtype, n, h, w, c, c // 8, c // 2)
        assert lib.spatial_attn_smem_bytes(
            code, plan.body, plan.tq, h, w, plan.c, plan.c8,
            plan.c2) == plan.smem_bytes
        assert lib.spatial_attn_kv_tokens(code, h, w, plan.c) > 0
    # 1024 queries a tile: no fit in either body
    assert lib.spatial_attn_smem_bytes(code, -1 if dtype == torch.float32
                                       else 0, 1024, 32, 32, 64, 8, 32) == 0


def test_k6_refuses_what_the_kernel_does_not_take(cuda):
    args = _attn_inputs(2, 8, 8, 64, torch.float32, cuda)
    x = args[0]
    for fn in (k6.spatial_attn_fused, k6.spatial_attn_tiled):
        # once refused, now taken: c8 = 9 (zero-padded weights), 4 keys
        for shape in ((2, 8, 8, 72), (2, 4, 4, 64)):
            a = _attn_inputs(*shape, torch.float32, cuda)
            torch.testing.assert_close(
                fn(*a), k6.spatial_attn_kernel_reference(*a), rtol=0,
                atol=1e-4)
        with pytest.raises(ValueError, match="even H and W"):
            fn(x[:, :7].contiguous(), *args[1:])
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(1, 2), *args[1:])
        with pytest.raises(TypeError, match="dtype"):
            fn(x.half(), *(a.half() for a in args[1:5]), args[5])
        with pytest.raises(TypeError, match="dtype"):
            fn(x.bfloat16(), *args[1:])
        with pytest.raises(TypeError, match="gamma must be float32"):
            fn(*args[:5], args[5].bfloat16())
        with pytest.raises(ValueError, match="several devices"):
            fn(x.cpu(), *args[1:])


@pytest.mark.parametrize("n,h,w,c", [(3, 16, 16, 64), (2, 64, 64, 64)])
def test_k6_grads_on_card_match_cpu(cuda, monkeypatch, n, h, w, c):
    """The Function on the card (kernel forward, the oracle recomputed in
    chunks of 2 frames for the backward) against the CPU's."""
    args = _attn_inputs(n, h, w, c, torch.float32, "cpu", seed=3)
    cot = torch.randn(n, h, w, c, generator=torch.Generator().manual_seed(4))
    monkeypatch.setattr(k6, "BWD_CHUNK_ELEMS", 2 * h * w * h * w // 4)
    entry = _attn_entry(h, w)

    def run(device):
        leaves = [a.to(device).requires_grad_(True) for a in args]
        out = entry(*leaves)
        return [out] + list(torch.autograd.grad(out, leaves, cot.to(device)))

    ref = run("cpu")
    before = entry.launches
    out = run(cuda)
    assert entry.launches - before == k6.LAUNCHES_PER_CALL   # none backward
    for o, r in zip(out, ref):
        o, r = o.detach().cpu(), r.detach()
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-5 * max(1.0, float(r.abs().max())))


ATTN_G_KW = dict(img_size=32, n_frames=4, ch=16, z_dim=120, n_classes=5,
                 emb_dim=16, attn_res=16)       # attention at 16×16×64


def test_generator_with_fused_attention_on_card(cuda):
    """G forward + backward on the card with `attn_fused="on"`, remat and
    not: K6a launches once per forward (two launches, none from the
    backward); against "off" on the card the clip and the gradients differ
    by f32 summation order only."""
    cfg = GConfig(**ATTN_G_KW, attn_fused="on")
    gen = torch.Generator().manual_seed(0)
    params, stats = generator.init(gen, cfg)
    params = tree.tree_map(
        lambda p: (p + 0.05 * torch.randn(p.shape, generator=gen)).to(cuda),
        params)
    stats = tree.tree_map(lambda s: s.to(cuda), stats)
    z = torch.randn(2, cfg.z_dim, generator=gen).to(cuda)
    y = torch.tensor([1, 3]).to(cuda)

    def run(cfg):
        leaves = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        flat = tree.flatten_with_paths(leaves)
        before = k6.spatial_attn_fused.launches
        video, new_stats = generator.apply(leaves, stats, z, y, cfg,
                                           train=True)
        grads = torch.autograd.grad((video ** 2).mean(), list(flat.values()))
        return (video.detach(), dict(zip(flat, grads)),
                tree.flatten_with_paths(new_stats),
                k6.spatial_attn_fused.launches - before)

    plain = run(cfg)
    remat = run(dataclasses.replace(cfg, remat=True))
    off = run(dataclasses.replace(cfg, attn_fused="off"))
    assert plain[3] == remat[3] == k6.LAUNCHES_PER_CALL and off[3] == 0
    for k, s in plain[2].items():
        assert torch.equal(s, remat[2][k]), k
    scale = max(float(g.abs().max()) for g in plain[1].values())

    def gap(a, b):
        return max(float((g - b[1][k]).abs().max())
                   for k, g in a[1].items()) / scale

    clip_gap = float((plain[0] - off[0]).abs().max())
    print(f"\nremat vs plain with the fused attention, over max|grad|: "
          f"{gap(plain, remat):.3e}; on vs off: clip {clip_gap:.3e}, "
          f"gradients over max|grad| {gap(plain, off):.3e}")
    assert gap(plain, remat) <= 2e-6
    # measured on an H100: clip 2.3e-6, gradients 2.2e-7 x max|grad|
    assert clip_gap <= 1e-5 and gap(plain, off) <= 2e-6


def test_train_step_with_fused_attention_on_card_matches_cpu(cuda):
    g_cfg = GConfig(**ATTN_G_KW, attn_fused="on")
    ds_cfg = DSConfig(img_size=32, ch=8, n_classes=5, k_frames=2)
    dt_cfg = DTConfig(img_size=32, n_frames=4, ch=8, n_classes=5)
    tc = train_state.TrainConfig(d_steps=2, ema_start=0)
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    for name, gamma in (("spatial", 0.6), ("temporal", -0.5)):
        state["g"]["params"]["attn"][name]["gamma"] = torch.tensor(gamma)
    gen = torch.Generator().manual_seed(1)
    real = torch.tanh(torch.randn(2, 4, 32, 32, 3, generator=gen))
    y = torch.tensor([1, 3])
    z = {i: torch.randn(2, 120, generator=gen) for i in (0, 3, 6)}
    idx = {i: torch.rand(2, 4, generator=gen).argsort(dim=1)[:, :2]
           for i in (1, 2, 4, 5, 7)}

    class Replay:
        def __init__(self, device):
            self.device = device

        def z(self, i):
            return z[i].to(self.device)

        def idx(self, i):
            return idx[i].to(self.device)

    ref_state, ref_m = step.train_step(state, real, y, Replay("cpu"), g_cfg,
                                       ds_cfg, dt_cfg, tc)

    def on_card(g_cfg):
        return step.train_step(
            train_state.to_device(state, cuda), real.to(cuda), y.to(cuda),
            Replay(cuda), g_cfg, ds_cfg, dt_cfg, tc)

    before = k6.spatial_attn_fused.launches
    out_state, out_m = on_card(g_cfg)
    # the fake pass and the G forward; nothing from the backward
    assert (k6.spatial_attn_fused.launches - before
            == 2 * k6.LAUNCHES_PER_CALL)
    off_state, _ = on_card(dataclasses.replace(g_cfg, attn_fused="off"))
    assert k6.spatial_attn_fused.launches - before == 2 * k6.LAUNCHES_PER_CALL
    for k in ref_m:
        torch.testing.assert_close(out_m[k].cpu(), ref_m[k], rtol=0,
                                   atol=1e-4)
    # with γ off zero the attention's softmaxes carry the card's other f32
    # summation order through G: measured on an H100, G's Adam mu (the
    # gradient) on the card is 8.46e-4 x max|mu| from the CPU's at its worst
    # leaf with "on" AND with "off" (printed as the witness), and the two
    # routes on the card are 4.4e-7 x max|mu| apart
    gaps = {"on, card vs CPU": _mu_gap((out_state,), (ref_state,)),
            "off, card vs CPU": _mu_gap((off_state,), (ref_state,)),
            "on vs off on the card": _mu_gap((out_state,), (off_state,))}
    for name, gap in gaps.items():
        print(f"\n{name}: " + ", ".join(
            f"{m} {err:.3e} at {leaf}" for m, (err, leaf) in gap.items()))
    for m in ("g", "ds", "dt"):
        assert gaps["on, card vs CPU"][m][0] <= 1.5e-3, m
        assert gaps["on vs off on the card"][m][0] <= 5e-6, m


def test_trainer_on_the_card_places_batches_and_checkpoints(cuda, tmp_path):
    """The trainer at test scale in bf16 on the card: the prefetched batch
    arrives on the card in the compute dtype with the loader's values, the
    schedule writes its files, and the async (pinned) checkpoint restores
    on the card with the state's bits."""
    import os

    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import checkpoint as ckpt
    from dvdgan_tpu_torch.train.trainer import Trainer
    from dvdgan_tpu_torch.utils.config import Config

    cfg = Config(dataset="synthetic", n_classes=5, img_size=32, n_frames=4,
                 ch=8, d_ch=8, emb_dim=16, attn_res=16, k_frames=2,
                 batch_size=2, d_steps=1, ema_start=0, device="cuda",
                 log_step=1, sample_step=2, model_save_step=2, total_step=4,
                 out_dir=str(tmp_path))
    tr = Trainer(cfg)
    try:
        metrics = tr.train()
        batches = tr.loader.epoch(0)
        clips, labels = next(batches)
        batches.close()
        real, y = tr._take(tr._place((clips, labels)))
    finally:
        tr.close()
    assert all(math.isfinite(v) for v in metrics.values())
    assert real.is_cuda and real.dtype == torch.bfloat16 and y.is_cuda
    assert torch.equal(real.cpu(), torch.from_numpy(clips).bfloat16())
    assert torch.equal(y.cpu(), torch.from_numpy(labels).long())
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2", "4"]
    assert os.path.isfile(tmp_path / "samples" / "4_grid.png")
    back = interop.train_state_paths(
        ckpt.restore(str(tmp_path / "checkpoints"), 4, tr.state))
    for k, v in interop.train_state_paths(tr.state).items():
        assert back[k].is_cuda and torch.equal(back[k], v), k


# ------------------------------------------------------------ CUDA graphs
def _graph_call(name, dtype, device):
    """(fn, wrapper): one call of kernel `name`'s wrapper on fixed inputs,
    and the wrapper whose counter counts its launches."""
    if name in ("K1", "K2", "K3", "K4"):
        t, b, h, w, c = {"K1": (3, 2, 4, 4, 64), "K2": (3, 2, 4, 4, 64),
                         "K3": (2, 2, 64, 64, 64),
                         "K4": (1, 2, 4, 4, 64)}[name]
        args = _inputs(t, b, h, w, c, dtype, device)
        if name == "K1":
            return (lambda: k1.gru_sequence_fused(*args),
                    k1.gru_sequence_fused)
        if name == "K2":
            hs = k1.gru_sequence_fused(*args)
            g = torch.randn(hs.shape, generator=torch.Generator()
                            .manual_seed(9)).to(device, dtype)
            return (lambda: k2.gru_sequence_bwd(*args, hs, g),
                    k2.gru_sequence_bwd)
        if name == "K3":
            return (lambda: k3.gru_sequence_blocked(*args),
                    k3.gru_sequence_blocked)
        gx, cx, h0, wg, wc = args
        return (lambda: k4.gru_cell_fused(gx[0], cx[0], h0, wg, wc),
                k4.gru_cell_fused)
    if name in ("K5a", "K5b"):
        wall, xp, up = _ups_inputs(2, 8, 8, 64, 32, dtype, device)
        if name == "K5a":
            return lambda: k5.ups2x(wall, xp), k5.ups2x
        return lambda: k5.ups2x_bwd(wall, xp, up), k5.ups2x_bwd
    if name == "artifact":
        return _artifact_call(dtype, device)
    if "@" in name:             # K6a@HxC: a shape of DOMAIN_SHAPES
        name, shape = name.split("@")
        hw, c = map(int, shape.split("x"))
    else:
        hw, c = (32 if name == "K6a" else 64), 64
    args = _attn_inputs(2, hw, hw, c, dtype, device)
    entry = _attn_entry(hw, hw)
    assert entry is (k6.spatial_attn_fused if name == "K6a"
                     else k6.spatial_attn_tiled)
    return lambda: entry(*args), entry


def _artifact_call(dtype, device):
    """A serving artifact (`serving.export_sampler`, both fused routes:
    K1's, K5a's and K6a's ops; C 64 at the attention) saved, loaded and
    called on fixed inputs; K1's counter counts its launches."""
    import tempfile
    cfg = GConfig(img_size=32, n_frames=4, ch=16, z_dim=120, n_classes=5,
                  emb_dim=16, attn_res=16, ups_fused="fwd", attn_fused="on")
    state = GeneratorState.create(cfg, seed=0)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    program = serving.export_sampler(state, cfg, 2, device, name)
    with tempfile.TemporaryDirectory() as d:
        torch.export.save(program, f"{d}/a.pt2")
        serve = serving.load_sampler(f"{d}/a.pt2")
    g = torch.Generator().manual_seed(4)
    z = torch.randn(2, cfg.z_dim, generator=g).to(device)
    y = torch.tensor([1, 3], device=device)
    return lambda: serve(z, y), k1.gru_sequence_fused


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5a", "K5b",
                                  "K6a", "K6b", "artifact", "K6a@4x256",
                                  "K6a@4x512", "K6a@32x384", "K6a@16x768",
                                  "K6a@8x1536", "K6b@64x384", "K6a@32x96"])
def test_kernel_replays_from_a_cuda_graph_with_its_eager_bits(cuda, name,
                                                               dtype):
    """Captured after a warm-up call, replayed twice with its outputs
    poisoned in between: the eager call's bits each time, the launches
    counted once, during the capture (`chip_smoke.graph_replay`). The
    per-launch `cudaFuncSetAttribute` calls, K1's and K5b's split-K
    counters and K4's cluster launch (bf16) are all inside the graph; so
    is a whole serving artifact's call (its K1, K5a and K6a ops)."""
    import chip_smoke

    if name == "K4" and dtype == torch.bfloat16:
        assert k4.plan(dtype, 2, 4, 4, 64) is not None   # the cluster form
    fn, wrapper = _graph_call(name, dtype, cuda)
    row = chip_smoke.graph_replay(name, fn, wrapper)
    assert row["launches_captured"] == row["launches_eager"] > 0


STEP_FLAGS = {
    "off": ["--img_size", "32", "--n_frames", "4", "--ch", "8", "--d_ch",
            "8", "--emb_dim", "16", "--attn_res", "16", "--k_frames", "2",
            "--batch_size", "2", "--n_classes", "5", "--bf16", "1"],
    "off_f32": ["--img_size", "32", "--n_frames", "4", "--ch", "8",
                "--d_ch", "8", "--emb_dim", "16", "--attn_res", "16",
                "--k_frames", "2", "--batch_size", "2", "--n_classes", "5",
                "--bf16", "0"],
    # C 64 at the 16² attention; both γ set off zero below
    "fused": ["--img_size", "32", "--n_frames", "4", "--ch", "16", "--d_ch",
              "8", "--emb_dim", "16", "--attn_res", "16", "--k_frames", "2",
              "--batch_size", "2", "--n_classes", "5", "--bf16", "1",
              "--ups_fused", "full", "--attn_fused", "on"],
    # DVD-GAN-FP: 2 real frames, 4 generated
    "fp": ["--img_size", "32", "--n_frames", "6", "--cond_frames", "2",
           "--ch", "8", "--d_ch", "8", "--emb_dim", "16", "--attn_res", "16",
           "--k_frames", "2", "--batch_size", "2", "--n_classes", "5",
           "--bf16", "1"],
    "fp_f32": ["--img_size", "32", "--n_frames", "6", "--cond_frames", "2",
               "--ch", "8", "--d_ch", "8", "--emb_dim", "16", "--attn_res",
               "16", "--k_frames", "2", "--batch_size", "2", "--n_classes",
               "5", "--bf16", "0"],
    # the 256 px schedules at a small size: remat, 2 micro-batches, K3
    "remat": ["--preset", "kinetics_256_48f", "--ch", "2", "--d_ch", "2",
              "--n_frames", "2", "--k_frames", "2", "--n_classes", "5",
              "--emb_dim", "8", "--batch_size", "2", "--grad_accum", "2",
              "--bf16", "0"],
}


@pytest.mark.parametrize("case", list(STEP_FLAGS))
def test_graphed_k_steps_give_the_eager_steps_bits(cuda, case):
    """`MultiStep` with K = 2 on the card (one CUDA graph, two calls: the
    second goes on from the state the graph copied back) against four
    eager `train_step` calls with the same batches and keyed draws: the
    same bits in every leaf and metric, the same launches per step. The
    f32 cases run under deterministic cuDNN: its default f32 weight
    gradients differ from run to run, eager against eager."""
    from dvdgan_tpu_torch.utils.config import parse_config

    f32 = not parse_config(STEP_FLAGS[case]).bf16
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=f32, allow_tf32=False):
        _graphed_k_steps_give_the_eager_steps_bits(cuda, case)


def _graphed_k_steps_give_the_eager_steps_bits(cuda, case):
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train.trainer import launch_counts
    from dvdgan_tpu_torch.utils.config import parse_config

    cfg = parse_config(STEP_FLAGS[case])
    g_cfg, ds_cfg, dt_cfg, tc = (cfg.g_config(), cfg.ds_config(),
                                 cfg.dt_config(), cfg.train_config())
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    state = train_state.create(cfg.seed, g_cfg, ds_cfg, dt_cfg)
    if case == "fused":
        for m in ("g", "g_ema"):
            params = state[m] if m == "g_ema" else state[m]["params"]
            for p in tree.flatten_with_paths(params):
                if p.rsplit("/", 1)[-1] == "gamma":
                    tree.flatten_with_paths(params)[p].fill_(0.5)
    state = train_state.to_device(state, cuda)
    gen = torch.Generator().manual_seed(3)
    b, t, hw = cfg.batch_size, g_cfg.n_frames, g_cfg.img_size
    # whole clips: an FP prefix, then the frames G generates
    reals = torch.tanh(torch.randn(4, b, cfg.n_frames, hw, hw, 3,
                                   generator=gen)).to(cuda, dtype)
    ys = torch.randint(0, cfg.n_classes, (4, b), generator=gen).to(cuda)
    want, want_m, before = state, [], launch_counts()
    for j in range(4):
        draws = step.TorchDraws(cfg.seed, 10 + j, b, g_cfg.z_dim, t,
                                ds_cfg.k_frames, dtype, cuda)
        want, m = step.train_step(want, reals[j], ys[j], draws, g_cfg,
                                  ds_cfg, dt_cfg, tc)
        want_m.append(m)
    eager_launches = {k: (n - before[k]) // 4
                      for k, n in launch_counts().items()}
    multi = step.MultiStep(state, 2, b, g_cfg, ds_cfg, dt_cfg, tc, cfg.seed,
                           dtype, cuda, launch_counts)
    got_m = []
    for call in range(2):
        got, metrics = multi(multi.state if call else state,
                             reals[2 * call:2 * call + 2],
                             ys[2 * call:2 * call + 2], 10 + 2 * call)
        got_m.append({k: v.clone() for k, v in metrics.items()})
    torch.cuda.synchronize()
    assert multi.graph is not None and multi.launches == eager_launches
    flat_want = interop.train_state_paths(want)
    flat_got = interop.train_state_paths(got)
    differ = [p for p, v in flat_want.items()
              if not torch.equal(v, flat_got[p])]
    assert not differ, differ[:10]
    for call in range(2):
        for k, v in got_m[call].items():
            assert torch.equal(v, torch.stack(
                [want_m[2 * call + j][k] for j in range(2)])), (call, k)


def test_f32_steps_repeat_bitwise_under_deterministic_cudnn(cuda):
    """Two eager f32 train steps from one state, twice: the same bits under
    deterministic cuDNN (which the f32 graph cases above run under). The
    leaves that differ under cuDNN's default algorithms are printed (PR
    13's card: most of them, ROADMAP Queue 3)."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.utils.config import parse_config

    cfg = parse_config(STEP_FLAGS["off_f32"])
    g_cfg, ds_cfg, dt_cfg, tc = (cfg.g_config(), cfg.ds_config(),
                                 cfg.dt_config(), cfg.train_config())
    state = train_state.to_device(
        train_state.create(0, g_cfg, ds_cfg, dt_cfg), cuda)
    gen = torch.Generator().manual_seed(3)
    reals = torch.tanh(torch.randn(2, 2, 4, 32, 32, 3, generator=gen)
                       ).to(cuda)
    ys = torch.randint(0, 5, (2, 2), generator=gen).to(cuda)

    def two_steps():
        st = state
        for j in range(2):
            draws = step.TorchDraws(0, j, 2, g_cfg.z_dim, 4, ds_cfg.k_frames,
                                    torch.float32, cuda)
            st, _ = step.train_step(st, reals[j], ys[j], draws, g_cfg,
                                    ds_cfg, dt_cfg, tc)
        torch.cuda.synchronize()
        return interop.train_state_paths(st)

    differ = {}
    for det in (False, True):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=det, allow_tf32=False):
            a, b = two_steps(), two_steps()
        differ[det] = [k for k in a if not torch.equal(a[k], b[k])]
        print(f"\nf32, cudnn.deterministic={det}: {len(differ[det])} of "
              f"{len(a)} leaves differ between two runs")
    assert not differ[True], differ[True][:10]


# ------------------------------------------------------------- evaluation
@pytest.mark.parametrize("net,feature,shape,kw", [
    ("i3d", "logits", (2, 16, 32, 32, 3), {}),
    ("i3d", "avgpool", (1, 24, 16, 16, 3), {}),
    ("inception", "pool", (2, 75, 75, 3), {}),
    ("inception", "logits", (2, 75, 75, 3), {}),
    ("c3d", "logits", (1, 16, 112, 112, 3),
     dict(input_mean=(90.0, 98.0, 102.0), input_bgr=True)),
])
def test_eval_network_on_card_matches_cpu(cuda, net, feature, shape, kw):
    """I3D, Inception-v3 and C3D at test size (no resize), the same params
    and inputs on the card and on the CPU, f32 with TF32 off:
    1e-4 × max|CPU|."""
    from chip_smoke import move_off_init
    from dvdgan_tpu_torch.eval import c3d, i3d, inception, layers
    mod = {"i3d": i3d, "inception": inception, "c3d": c3d}[net]
    params = move_off_init(mod.init(torch.Generator().manual_seed(1)),
                           torch.Generator().manual_seed(2))
    x = torch.rand(shape, generator=torch.Generator().manual_seed(3)) * 2 - 1
    card = {k: v.to(cuda) for k, v in params.items()}
    with layers.exact_f32():
        got = mod.apply(card, x.to(cuda), feature, None, **kw).cpu()
        ref = mod.apply(params, x, feature, None, **kw)
    err = float((got - ref).abs().max())
    print(f"{net} {feature} {shape}: card vs cpu {err:.3e} of "
          f"{float(ref.abs().max()):.3e}")
    assert err <= 1e-4 * float(ref.abs().max())


def test_evaluate_generator_on_card_repeats_bitwise(cuda, tmp_path):
    """The harness at test scale in bf16 on the card (K1 samples the
    fakes): finite metrics, the same fvd twice, and the fakes reach the
    extractor as CUDA tensors."""
    from dvdgan_tpu_torch.eval import (ClassifierProbs, I3DLikeFeatures,
                                       evaluate_generator)
    from dvdgan_tpu_torch.train.trainer import Trainer
    from dvdgan_tpu_torch.utils.config import Config

    tr = Trainer(Config(dataset="synthetic", n_classes=3, img_size=32,
                        n_frames=4, ch=8, d_ch=8, k_frames=2, batch_size=2,
                        d_steps=1, device="cuda", out_dir=str(tmp_path)))
    fx = I3DLikeFeatures(widths=(8, 16), device=cuda)
    seen = []

    def recording(video):
        seen.append(isinstance(video, torch.Tensor) and video.is_cuda)
        return fx(video)

    clf = ClassifierProbs(3, feature_extractor=fx)
    before = k1.gru_sequence_fused.launches
    try:
        runs = [evaluate_generator(tr, recording, n_samples=24, batch_size=8,
                                   classifier=clf) for _ in range(2)]
    finally:
        tr.close()
    assert k1.gru_sequence_fused.launches > before
    assert runs[0] == runs[1] and math.isfinite(runs[0]["fvd"])
    assert seen.count(True) == 6 and 1.0 <= runs[0]["is_mean"] <= 3.0


# ------------------------------------------------- two gloo ranks on cuda:0
def _two_ranks_on_the_card(local_rank: int, out: str) -> None:
    """A rank of `test_collectives_on_two_gloo_ranks_on_the_card`: the
    cross-replica moments and their gradient, the halos and their
    cotangents, on CUDA tensors; and MultiStep refusing the group."""
    import numpy as np
    import torch.distributed as dist

    from dvdgan_tpu_torch.ops import norm
    from dvdgan_tpu_torch.parallel import collectives
    from dvdgan_tpu_torch.parallel import mesh as pmesh

    device = torch.device("cuda", 0)
    par = pmesh.init_from_env(device, 1, 2, timeout_s=60)
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(6, 5, 5, 4, generator=g)
        a, b = torch.randn(4, generator=g), torch.randn(4, generator=g)
        clip = torch.randn(2, 6, 3, 3, 2, generator=g)
        w = torch.randn(2, 3, 3, 2, generator=g)
        r = par.rank
        xr = x[3 * r:3 * (r + 1)].to(device).requires_grad_(True)
        mean, var = norm._batch_moments(xr, par.data_group)
        ((mean * a.to(device)).sum() + (var * b.to(device)).sum()).backward()
        part = clip[:, 3 * r:3 * (r + 1)].to(device).requires_grad_(True)
        left, right = collectives.halos(part, dist.group.WORLD)
        ((left * w.to(device)).sum()
         + 2 * (right * w.to(device)).sum()).backward()
        cfgs = (GConfig(img_size=32, n_frames=4, ch=8, z_dim=120,
                        n_classes=5, emb_dim=16, attn_res=16),
                DSConfig(img_size=32, ch=8, n_classes=5, k_frames=2),
                DTConfig(img_size=32, n_frames=4, ch=8, n_classes=5),
                train_state.TrainConfig(d_steps=1))
        try:
            step.MultiStep({}, 2, 1, *cfgs, 0, torch.float32, device,
                           group=par.data_group)
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        np.savez(f"{out}/r{r}.npz", mean=mean.detach().cpu().numpy(),
                 var=var.detach().cpu().numpy(), dx=xr.grad.cpu().numpy(),
                 left=left.detach().cpu().numpy(),
                 right=right.detach().cpu().numpy(),
                 dpart=part.grad.cpu().numpy(), backend=par.backend,
                 refused=refused)
    finally:
        par.close()


def test_collectives_on_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two ranks sharing cuda:0 (gloo, CUDA tensors): the moments and
    `all_mean`'s gradient against the CPU's whole batch (the gradient of
    the two ranks' summed losses: twice the one-process one), the halos
    and their cotangents bitwise, and `MultiStep` refusing the group."""
    import numpy as np

    from dvdgan_tpu_torch.ops import norm
    from dvdgan_tpu_torch.parallel import mesh as pmesh

    pmesh.spawn(_two_ranks_on_the_card, 2, (str(tmp_path),), timeout_s=120)
    res = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 5, 4, generator=g).requires_grad_(True)
    a, b = torch.randn(4, generator=g), torch.randn(4, generator=g)
    clip = torch.randn(2, 6, 3, 3, 2, generator=g)
    w = torch.randn(2, 3, 3, 2, generator=g)
    mean, var = norm._batch_moments(x)
    ((mean * a).sum() + (var * b).sum()).backward()
    for r in res:
        assert str(r["backend"]) == "gloo"
        assert "CUDA graph cannot" in str(r["refused"])
        torch.testing.assert_close(torch.from_numpy(r["mean"]),
                                   mean.detach(), rtol=0, atol=1e-6)
        torch.testing.assert_close(torch.from_numpy(r["var"]), var.detach(),
                                   rtol=0, atol=1e-6)
    dx = torch.from_numpy(np.concatenate([r["dx"] for r in res]))
    torch.testing.assert_close(dx, 2 * x.grad, rtol=1e-5, atol=1e-6)
    zero = torch.zeros_like(clip[:, 0])
    assert torch.equal(torch.from_numpy(res[0]["left"]), zero)
    assert torch.equal(torch.from_numpy(res[0]["right"]), clip[:, 3])
    assert torch.equal(torch.from_numpy(res[1]["left"]), clip[:, 2])
    assert torch.equal(torch.from_numpy(res[1]["right"]), zero)
    want = torch.zeros(2, 6, 3, 3, 2)
    want[:, 2], want[:, 3] = w, 2 * w
    got = torch.cat([torch.from_numpy(r["dpart"]) for r in res], dim=1)
    assert torch.equal(got, want)


# ------------------------------------------------------ registered ops
def _op_call(name, dtype, device):
    """(op, args, eager entry, entry args, plain version) of a registered
    op of `kernels/library.py` at a small shape."""
    if name in ("gru_sequence_fused", "gru_sequence_blocked"):
        hw = 4 if name == "gru_sequence_fused" else 64
        args = _inputs(3, 2, hw, hw, 16, dtype, device)
        entry = getattr(k1 if hw == 4 else k3, name)
        return args, entry, args, k1.gru_sequence_reference
    if name == "ups2x":
        wall, xp, _ = _ups_inputs(2, 8, 8, 64, 32, dtype, device)
        return (wall, xp), k5.ups2x, (wall, xp), k5.ups2x_reference
    hw = 32 if name == "spatial_attn_fused" else 64
    args = _attn_inputs(2, hw, hw, 64, dtype, device)
    return (args, getattr(k6, name), args,
            k6.spatial_attn_kernel_reference)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["gru_sequence_fused",
                                  "gru_sequence_blocked", "ups2x",
                                  "spatial_attn_fused", "spatial_attn_tiled"])
def test_registered_op_matches_its_kernel_and_plain_version(cuda, name,
                                                            dtype):
    """Each `dvdgan::` op on CUDA tensors launches its kernel (the entry's
    launches, counted on the entry) and gives the eager entry's bits; the
    plain version on the same tensors agrees at the kernel tests' limits
    (K6 in bf16: one ulp on at most 0.5% of the elements)."""
    args, entry, entry_args, plain = _op_call(name, dtype, cuda)
    op = getattr(torch.ops.dvdgan, name)
    before = entry.launches
    out = op(*args)
    torch.cuda.synchronize()
    launched = entry.launches - before
    want = entry(*entry_args)
    assert launched == entry.launches - before - launched > 0
    assert torch.equal(out, want)
    ref = plain(*args)
    if name.startswith("spatial") and dtype == torch.bfloat16:
        assert float((out != ref).float().mean()) <= 0.005
        assert float((out.float() - ref.float()).abs().max()) <= _bf16_ulp(
            float(ref.float().abs().max()))
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=TOL[dtype])

