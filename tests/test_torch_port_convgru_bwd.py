"""K2 (the reverse-time ConvGRU BPTT) and K1's autograd.Function, port vs
dvdgan_tpu: K2's plain version against the reference's Pallas kernel run in
interpret mode, on all five outputs; the Function's gradients against
`jax.vjp` of `gru_sequence_scan` (the reference's own CPU path); and
`ops/convgru.convgru` under autograd, where gx/cx reach the Function as
channel slices of the hoisted input conv or, at level 0 (`x_static`), as a
stride-0 broadcast over T.

f32: atol 1e-5. bf16: atol 2e-2 (the summation orders differ and a flipped
bf16 rounding of rh, da or the dh carry compounds over the steps).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import convgru_bwd as jbwd
from dvdgan_tpu.kernels import convgru_seq as jseq
from dvdgan_tpu.ops import convgru as jconvgru
from dvdgan_tpu_torch.kernels import convgru_bwd as k2
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.ops import convgru

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
NAMES = ("dgx", "dcx", "dh0", "dwg", "dwc")


def seq_inputs(seed, t=3, b=2, h=5, w=6, c=8):
    """gx, cx, h0, wg, wc and an upstream gradient g of hs."""
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.randn(t, b, h, w, 2 * c), rng.randn(t, b, h, w, c),
        np.tanh(rng.randn(b, h, w, c)), 0.1 * rng.randn(3, 3, c, 2 * c),
        0.1 * rng.randn(3, 3, c, c), rng.randn(t, b, h, w, c))]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 2, 5, 6, 8), (4, 2, 4, 4, 16)],
                         ids=["ragged", "small_plane"])
def test_k2_plain_matches_interpreted_kernel(dt, shape):
    *arrays, g = seq_inputs(0, *shape)
    j = [jnp.asarray(a).astype(JDT[dt]) for a in arrays]
    hs = jseq.gru_sequence_fused(*j, True)       # the kernel's own forward
    jg = jnp.asarray(g).astype(JDT[dt])
    ref = jbwd.gru_sequence_bwd(*j, hs, jg, interpret=True)
    t = [torch.from_numpy(f32(a)).to(TDT[dt]) for a in (*j, hs, jg)]
    ours = k2.gru_sequence_bwd_reference(*t)
    for name, o, r in zip(NAMES, ours, ref):
        assert o.dtype == TDT[dt] and tuple(o.shape) == r.shape, name
        np.testing.assert_allclose(f32(o), f32(r), atol=TOL[dt], rtol=0,
                                   err_msg=name)


def test_k2_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version (no launches), also
    for strided gx/cx, and dgx/dcx come out dense."""
    gx, cx, h0, wg, wc, g = (torch.from_numpy(a) for a in seq_inputs(1))
    hs = k1.gru_sequence_reference(gx, cx, h0, wg, wc)
    before = k2.gru_sequence_bwd.launches
    ref = k2.gru_sequence_bwd_reference(gx, cx, h0, wg, wc, hs, g)
    gcx = torch.cat([gx, cx], dim=-1)
    c = h0.shape[-1]
    out = k2.gru_sequence_bwd(gcx[..., :2 * c], gcx[..., 2 * c:], h0, wg, wc,
                              hs, g)
    assert k2.gru_sequence_bwd.launches == before
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert out[0].is_contiguous() and out[1].is_contiguous()
    with pytest.raises(ValueError, match="g has shape"):
        k2.gru_sequence_bwd(gx, cx, h0, wg, wc, hs, g[:, :1])


def test_gru_function_grads_match_jax_vjp():
    """The autograd.Function (K1 forward, saved hs, K2 backward) against
    jax.vjp of gru_sequence_scan, the reference's path on the CPU."""
    *arrays, g = seq_inputs(2)
    hs_ref, vjp = jax.vjp(lambda *a: jseq.gru_sequence_scan(*a),
                          *[jnp.asarray(a) for a in arrays])
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    hs = k1.gru_sequence_fused(*leaves)
    assert hs.grad_fn is not None
    np.testing.assert_allclose(f32(hs), np.asarray(hs_ref), atol=1e-5)
    ours = torch.autograd.grad(hs, leaves, torch.from_numpy(g))
    for name, o, r in zip(NAMES, ours, ref):
        np.testing.assert_allclose(f32(o), np.asarray(r), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("x_static", [False, True],
                         ids=["channel_slices", "x_static_broadcast"])
def test_convgru_grads_match_reference(x_static):
    """Gradients of ops/convgru.convgru with respect to its params and its
    input, against jax.vjp of the reference's convgru (time-major)."""
    c, t, b = 8, 3, 2
    rng = np.random.RandomState(3)
    p = jconvgru.convgru_init(jax.random.PRNGKey(3), c)
    p = jax.tree.map(lambda a: np.asarray(a) + np.float32(0.1) * rng.randn(
        *a.shape).astype(np.float32), p)
    x = rng.randn(t, b, 5, 6, c).astype(np.float32)
    if x_static:        # level 0: the same frame at every step
        x = np.broadcast_to(x[:1], x.shape).copy()
    up = rng.randn(t, b, 5, 6, c).astype(np.float32)

    def jf(p, x):
        return jconvgru.convgru(p, x, time_major=True, x_static=x_static)

    hs_ref, vjp = jax.vjp(jf, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    dp_ref, dx_ref = vjp(jnp.asarray(up))

    tp = {k: {n: torch.from_numpy(v.copy()).requires_grad_(True)
              for n, v in d.items()} for k, d in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    hs = convgru.convgru(tp, tx, time_major=True, x_static=x_static)
    np.testing.assert_allclose(f32(hs), np.asarray(hs_ref), atol=1e-5)
    flat = [(k, n, v) for k, d in tp.items() for n, v in d.items()]
    grads = torch.autograd.grad(hs, [tx] + [v for *_, v in flat],
                                torch.from_numpy(up))
    np.testing.assert_allclose(f32(grads[0]), np.asarray(dx_ref), atol=1e-5)
    for (k, n, _), gr in zip(flat, grads[1:]):
        np.testing.assert_allclose(f32(gr), np.asarray(dp_ref[k][n]),
                                   atol=1e-5, err_msg=f"{k}/{n}")
