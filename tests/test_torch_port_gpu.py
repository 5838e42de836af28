"""dvdgan_tpu_torch kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors. Marked `gpu`; each test skips
(inside the `cuda` fixture) where there is no CUDA device. Run them on a
machine with one: `python -m pytest tests/test_torch_port_gpu.py -q`.

f32 with TF32 off: atol 1e-5 at these small shapes. bf16: atol 2e-2 (the
same bound as the CPU tests hold the plain version to against JAX).
"""

from __future__ import annotations

import pytest
import torch

from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.models import GConfig
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.ops import convgru
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
