"""dvdgan_tpu_torch kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the paths through them (the
sample, K1's autograd.Function, one train step) on the card against the
CPU. Marked `gpu`; each test skips (inside the `cuda` fixture) where there
is no CUDA device. Run them on a machine with one:
`python -m pytest tests/test_torch_port_gpu.py -q --noconftest`.

f32 with TF32 off: atol 1e-5 at these small shapes (1e-4 for whole paths
and for K2's weight gradients, sums over T·B·H·W terms). bf16: atol 2e-2
(the same bound as the CPU tests hold the plain version to against JAX),
relative to the largest reference value for K2's outputs.
"""

from __future__ import annotations

import pytest
import torch

from dvdgan_tpu_torch.core import tree
from dvdgan_tpu_torch.kernels import convgru_bwd as k2
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.ops import convgru
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
    draws = step.TorchDraws(gen, 2, 120, 4, 2, torch.float32)
    z = {i: draws.z(i) for i in (0, 3, 6)}
    idx = {i: draws.idx(i) for i in (1, 2, 4, 5, 7)}

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
