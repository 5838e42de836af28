"""K1 (whole-sequence ConvGRU forward) and the modules around it, port vs
dvdgan_tpu: the kernel's plain version against the reference's oracle
(`_seq_reference`) and its Pallas kernel run in interpret mode; `convgru`,
`separable_attn` (γ ≠ 0) and `gresblock` against the JAX functions.

f32: atol 1e-5. bf16: atol 2e-2 — the summation orders differ and the bf16
ulp at |h| ≤ 1 is 2⁻⁸; errors compound over the recurrence.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import convgru_seq as jseq
from dvdgan_tpu.ops import attention as jattn
from dvdgan_tpu.ops import convgru as jconvgru
from dvdgan_tpu.ops import resblocks as jres
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.ops import attention, convgru, resblocks

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def tt(x):
    if isinstance(x, dict):
        return {k: tt(v) for k, v in x.items()}
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def seq_inputs(seed, t=3, b=2, h=5, w=6, c=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, b, h, w, 2 * c).astype(np.float32),
            rng.randn(t, b, h, w, c).astype(np.float32),
            np.tanh(rng.randn(b, h, w, c)).astype(np.float32),
            (0.1 * rng.randn(3, 3, c, 2 * c)).astype(np.float32),
            (0.1 * rng.randn(3, 3, c, c)).astype(np.float32))


def as_dtype(arrays, dt):
    """The same values in both frameworks at dtype dt (rounded once)."""
    j = [jnp.asarray(a).astype(JDT[dt]) for a in arrays]
    t = [torch.from_numpy(a).to(TDT[dt]) for a in arrays]
    return j, t


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("oracle", ["seq_reference", "pallas_interpret"])
def test_k1_plain_matches_reference(dt, oracle):
    j, t = as_dtype(seq_inputs(0), dt)
    ours = k1.gru_sequence_reference(*t)
    if oracle == "seq_reference":
        ref = jseq._seq_reference(*j)
    else:
        ref = jseq.gru_sequence_fused(*j, True)
    assert ours.dtype == TDT[dt] and ours.shape == tuple(ref.shape)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=TOL[dt])


def test_k1_wrapper_takes_plain_version_on_cpu_for_strided_inputs():
    """The kernel's accepted layouts (channel slices of the hoisted conv,
    a stride-0 broadcast over T) give the contiguous inputs' result."""
    gx, cx, h0, wg, wc = (torch.from_numpy(a) for a in seq_inputs(1))
    gcx = torch.cat([gx, cx], dim=-1)               # (T, B, H, W, 3C)
    c = h0.shape[-1]
    sliced = k1.gru_sequence_fused(gcx[..., :2 * c], gcx[..., 2 * c:], h0,
                                   wg, wc)
    torch.testing.assert_close(sliced, k1.gru_sequence_reference(
        gx, cx, h0, wg, wc), rtol=0, atol=0)
    t = gx.shape[0]
    bgx, bcx = gx[:1].expand(t, -1, -1, -1, -1), cx[:1].expand(t, -1, -1, -1, -1)
    torch.testing.assert_close(
        k1.gru_sequence_fused(bgx, bcx, h0, wg, wc),
        k1.gru_sequence_reference(bgx.contiguous(), bcx.contiguous(), h0, wg,
                                  wc), rtol=0, atol=0)
    assert k1._pixel_strides(gcx[..., :2 * c], "gx") == (
        gcx.stride(1), 3 * c)
    assert k1._pixel_strides(bgx, "gx")[0] == gx.stride(1)


def test_k1_wrapper_refuses_what_it_cannot_take():
    gx, cx, h0, wg, wc = (torch.from_numpy(a) for a in seq_inputs(2))
    with pytest.raises(NotImplementedError, match="training slice"):
        k1.gru_sequence_fused(gx, cx, h0, wg.requires_grad_(), wc)
    wg.requires_grad_(False)
    with pytest.raises(ValueError, match="wc has shape"):
        k1.gru_sequence_fused(gx, cx, h0, wg, wc[:, :, :, :-1])
    with pytest.raises(ValueError, match="not channel-contiguous"):
        k1._pixel_strides(gx.transpose(2, 3), "gx")
    with pytest.raises(ValueError, match="not channel-contiguous"):
        k1._pixel_strides(gx[..., ::2], "gx")
    with torch.no_grad():     # no graph, so no backward is needed
        k1.gru_sequence_fused(gx, cx, h0, wg.requires_grad_(), wc)


@pytest.mark.parametrize("time_major,x_static", [(True, True), (True, False),
                                                 (False, False)])
def test_convgru_matches_reference(time_major, x_static):
    c = 8
    p = jconvgru.convgru_init(jax.random.PRNGKey(3), c)
    rng = np.random.RandomState(4)
    p = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32),
                     p)                               # non-zero biases too
    shape = (3, 2, 6, 6, c) if time_major else (2, 3, 6, 6, c)
    x = rng.randn(*shape).astype(np.float32)
    if x_static:
        x = np.broadcast_to(x[:1], shape).copy()
    ref = jconvgru.convgru(p, jnp.asarray(x), use_pallas=False,
                           time_major=time_major, x_static=x_static)
    ours = convgru.convgru(tt(p), torch.from_numpy(x), time_major=time_major,
                           x_static=x_static)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("time_major", [True, False])
def test_separable_attn_matches_reference_with_gamma(time_major):
    c = 16
    p = jattn.separable_attn_init(jax.random.PRNGKey(5), c)
    p = {k: dict(v, gamma=jnp.float32(g)) for (k, v), g in
         zip(p.items(), (0.7, -0.4))}                 # γ = 0 hides the branch
    shape = (3, 2, 4, 6, c) if time_major else (2, 3, 4, 6, c)
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    ref = jattn.separable_attn(p, jnp.asarray(x), use_pallas=False,
                               time_major=time_major)
    ours = attention.separable_attn(tt(p), torch.from_numpy(x),
                                    time_major=time_major)
    assert not np.allclose(np.asarray(ref), x, atol=1e-3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cin,cout", [(8, 4), (6, 6)])
def test_gresblock_matches_reference(train, cin, cout):
    cond_dim = 5
    p = jres.gresblock_init(jax.random.PRNGKey(7), cin, cout, cond_dim)
    rng = np.random.RandomState(8)
    p = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32),
                     p)
    stats = {k: {"mean": (0.2 * rng.randn(n)).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
             for k, n in (("bn1", cin), ("bn2", cout))}
    x = rng.randn(4, 3, 5, cin).astype(np.float32)
    cond = rng.randn(4, cond_dim).astype(np.float32)
    jy, js = jres.gresblock(p, stats, jnp.asarray(x), jnp.asarray(cond),
                            train=train, upsample=True)
    ty, ts = resblocks.gresblock(tt(p), tt(stats), torch.from_numpy(x),
                                 torch.from_numpy(cond), train=train,
                                 upsample=True)
    assert ("skip" in p) == (cin != cout)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for k in ("bn1", "bn2"):
        for m in ("mean", "var"):
            np.testing.assert_allclose(ts[k][m].numpy(), np.asarray(js[k][m]),
                                       atol=1e-5)
