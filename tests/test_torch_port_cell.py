"""The single-step ConvGRU entry (K4), port vs dvdgan_tpu, on the CPU.

The same numpy-seeded inputs go through `kc.gru_cell_fused(..., interpret=
True)` (the Pallas cell kernel interpreted, as `tests/test_kernels.py` runs
it) and the port's plain version and entry:

  * `gru_cell_reference` vs the interpreted kernel: f32 atol 1e-5; bf16
    atol 2e-2 (one bf16 ulp at |h| ≤ 4) with the count of differing
    elements printed (both sum in f32 and round where the kernel body
    rounds);
  * T steps of `ops.convgru.convgru_cell` equal `ops.convgru.convgru`
    bitwise in the port (K4's plain version is one step of K1's), and the
    reference's own unroll to atol 1e-5;
  * the entry's gradients (its backward is K2's plain version at T = 1) vs
    `jax.grad` through the interpreted kernel (whose backward is a plain
    recompute): f32 atol 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import convgru_cell as kc
from dvdgan_tpu.ops import convgru as jconvgru
from dvdgan_tpu_torch import kernels
from dvdgan_tpu_torch.kernels import convgru_cell
from dvdgan_tpu_torch.ops import convgru

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cell_inputs(seed, b=2, h=6, w=6, c=8):
    """(gx, cx, h, wg, wc) as f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, 2 * c).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32),
            (0.1 * rng.randn(3, 3, c, 2 * c)).astype(np.float32),
            (0.1 * rng.randn(3, 3, c, c)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 6, 6, 8), (3, 4, 5, 4), (1, 9, 10, 6)],
                         ids=str)
def test_cell_reference_matches_interpreted_kernel(shape, dtype):
    args = cell_inputs(0, *shape)
    ref = kc.gru_cell_fused(*(jnp.asarray(a, JDT[dtype]) for a in args), True)
    ours = convgru_cell.gru_cell_reference(
        *(torch.from_numpy(a).to(TDT[dtype]) for a in args))
    assert ours.dtype == TDT[dtype] and ours.shape == ref.shape
    got, want = ours.float().numpy(), np.asarray(ref, np.float32)
    if dtype == "bfloat16":
        print(f"\nbf16 elements that differ from the interpreted kernel: "
              f"{int((got != want).sum())} of {got.size}")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_cell_entry_is_its_plain_version_on_cpu_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in cell_inputs(1)]
    before = kernels.gru_cell_fused.launches
    out = kernels.gru_cell_fused(*args)
    assert kernels.gru_cell_fused.launches == before
    assert out.grad_fn is None
    assert torch.equal(out, convgru_cell.gru_cell_reference(*args))
    # one step of K1's entry
    seq = kernels.gru_sequence_fused(args[0][None], args[1][None], *args[2:])
    assert torch.equal(out, seq[0])
    with pytest.raises(ValueError, match="want gx"):
        kernels.gru_cell_fused(args[0][None], *args[1:])
    with pytest.raises(ValueError, match="has shape"):
        kernels.gru_cell_fused(args[0], args[1][..., :-1], *args[2:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("time_major", [False, True])
def test_unrolled_cell_equals_convgru_bitwise(dtype, time_major):
    gen = torch.Generator().manual_seed(0)
    c, t = 8, 5
    p = convgru.convgru_init(gen, c)
    p = {k: {n: (v + 0.1 * torch.randn(v.shape, generator=gen)).to(TDT[dtype])
             for n, v in d.items()} for k, d in p.items()}
    x = torch.randn(2, t, 6, 6, c, generator=gen).to(TDT[dtype])
    if time_major:
        x = x.movedim(1, 0).contiguous()
    y = convgru.convgru(p, x, time_major=time_major)
    h = torch.zeros(2, 6, 6, c, dtype=TDT[dtype])
    outs = []
    for i in range(t):
        h = convgru.convgru_cell(p, x[i] if time_major else x[:, i], h)
        outs.append(h)
    assert torch.equal(torch.stack(outs, 0 if time_major else 1), y)
    assert float(y.float().abs().max()) > 0.1


def test_convgru_cell_matches_reference_cell():
    """`ops.convgru.convgru_cell` from raw x against the reference's, f32."""
    c = 4
    jp = jconvgru.convgru_init(jax.random.PRNGKey(3), c)
    rng = np.random.RandomState(4)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.randn(
        *a.shape)).astype(np.float32), jp)
    x = rng.randn(2, 3, 6, 6, c).astype(np.float32)
    p = {k: {n: torch.from_numpy(np.asarray(v)) for n, v in d.items()}
         for k, d in jp.items()}
    h = torch.zeros(2, 6, 6, c)
    jh = jnp.zeros((2, 6, 6, c))
    for i in range(3):
        h = convgru.convgru_cell(p, torch.from_numpy(x[:, i]), h)
        jh = jconvgru.convgru_cell(jp, jnp.asarray(x[:, i]), jh)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-5)


def test_cell_gradients_match_interpreted_kernel():
    args = cell_inputs(2, b=1, h=4, w=5, c=4)
    up = np.random.RandomState(3).randn(1, 4, 5, 4).astype(np.float32)

    def loss(*a):
        return (kc.gru_cell_fused(*a, True) * jnp.asarray(up)).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = kernels.gru_cell_fused(*leaves)
    assert out.grad_fn is not None
    ours = torch.autograd.grad((out * torch.from_numpy(up)).sum(), leaves)
    for name, a, b in zip(("gx", "cx", "h", "wg", "wc"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cell_bf16_gradients_round_elsewhere_than_the_reference(seed):
    """In bf16 the entry's backward (K2's plain version: gates recomputed
    in f32, rh, da and dh rounded once) and the reference cell's (a plain
    recompute with the gates in bf16, `_cell_recompute_bwd`) round at
    different places: 0.3-0.9% of max|ref| measured, held at 2%."""
    args = cell_inputs(seed)
    args = args[:2] + (np.tanh(args[2]),) + args[3:]
    up = np.random.RandomState(seed + 10).randn(2, 6, 6, 8).astype(np.float32)

    def loss(*a):
        out = kc.gru_cell_fused(*a, True).astype(jnp.float32)
        return (out * jnp.asarray(up)).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a, jnp.bfloat16) for a in args))
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in args]
    out = kernels.gru_cell_fused(*leaves)
    ours = torch.autograd.grad((out.float() * torch.from_numpy(up)).sum(),
                               leaves)
    for name, a, b in zip(("gx", "cx", "h", "wg", "wc"), ours, ref):
        want = np.asarray(b, np.float32)
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=name)


def test_convgru_cell_gradients_reach_every_parameter():
    gen = torch.Generator().manual_seed(5)
    p = convgru.convgru_init(gen, 4)
    leaves = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
              for k, d in p.items()}
    x = torch.randn(2, 6, 6, 4, generator=gen, requires_grad=True)
    h = torch.randn(2, 6, 6, 4, generator=gen, requires_grad=True)
    flat = [x, h] + [v for d in leaves.values() for v in d.values()]
    grads = torch.autograd.grad(convgru.convgru_cell(leaves, x, h).sum(), flat)
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("h,w,smem,want", [
    (4, 4, 50_000, True), (8, 8, 200_000, True), (8, 8, 232_449, False),
    (8, 9, 50_000, False), (16, 16, 50_000, False), (128, 128, 50_000, False),
])
def test_single_launch_rule(h, w, smem, want):
    """One launch where the plane fits one CTA's tile and shared memory."""
    assert convgru_cell.single_launch(h, w, smem) is want
