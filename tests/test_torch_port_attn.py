"""The fused spatial attention (K6a/K6b), port vs dvdgan_tpu, on the CPU.

The same numpy-seeded inputs go through the JAX entries with their Pallas
kernels interpreted (as `tests/test_kernels.py` runs them) and the port's
plain versions and entries:

  * `spatial_attn_kernel_reference` (the kernel's roundings) vs
    `spatial_attn_fused(*args, True)` and `spatial_attn_tiled(*args, True,
    force_bqr)` for force_bqr in (None, 2, 4): f32 atol 1e-5; bf16 within
    one bf16 ulp at the output's scale, with the count of differing elements
    printed (both keep q, k and the logits in f32 and round attn, v, o and
    out once, so they differ only where f32 sums in another order straddle
    a rounding boundary);
  * `spatial_attn_reference` (the backward's math) vs the reference's oracle
    `_spatial_attn_reference`: f32 atol 1e-5, bf16 one ulp;
  * the gradients of x, the four weights and γ through the port's entries
    (autograd.Function, recompute through the oracle) vs `jax.grad` through
    the interpreted entries: atol 1e-4; the chunked recompute equals the
    unchunked one;
  * γ = 0 gives x back bit for bit; a `force_bqr` that does not divide H, an
    odd H and mismatched weights raise; CPU tensors launch nothing;
  * in bf16 the oracle rounds q, k, v and the logits where the kernel does
    not: the difference between the two is measured on both sides and held
    under two bf16 ulps of the output's scale.

The CPU backend of XLA has no bf16 × bf16 → f32 dot, which the kernel
bodies ask for (`preferred_element_type`): for the bf16 cases the test
gives the kernel module a `jnp` whose `dot` upcasts both operands first —
the same products (a bf16 × bf16 product is exact in f32) and f32 sums.
"""

from __future__ import annotations

import math
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import attention_spatial as jka
from dvdgan_tpu_torch.kernels import attention_spatial as ka

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ENTRIES = {"fused": (lambda *a: jka.spatial_attn_fused(*a, True),
                     ka.spatial_attn_fused),
           "tiled": (lambda *a: jka.spatial_attn_tiled(*a, True, 2),
                     lambda *a: ka.spatial_attn_tiled(*a, force_bqr=2))}


@pytest.fixture
def bf16_dot(monkeypatch):
    """Lets the interpreted kernel bodies run in bf16 on the CPU."""
    def dot(a, b, preferred_element_type=None):
        out = jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
        return out.astype(preferred_element_type or a.dtype)

    monkeypatch.setattr(jka, "jnp",
                        types.SimpleNamespace(**{**vars(jnp), "dot": dot}))


def attn_inputs(seed, n=3, h=8, w=8, c=16, gamma=0.7):
    """(x, wq, wk, wv, wo, gamma) as f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c).astype(np.float32),
            (0.3 * rng.randn(c, c // 8)).astype(np.float32),
            (0.3 * rng.randn(c, c // 8)).astype(np.float32),
            (0.3 * rng.randn(c, c // 2)).astype(np.float32),
            (0.3 * rng.randn(c // 2, c)).astype(np.float32),
            np.float32(gamma))


def to_jax(args, dtype="float32"):
    return (*(jnp.asarray(a, JDT[dtype]) for a in args[:5]),
            jnp.asarray(args[5], jnp.float32))


def to_torch(args, dtype="float32"):
    return (*(torch.from_numpy(a).to(TDT[dtype]) for a in args[:5]),
            torch.tensor(float(args[5])))


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp (8 significand bits) at magnitude `scale`."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def assert_close(ours: torch.Tensor, ref, dtype: str, what: str,
                 ulps: int = 1):
    got, want = ours.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == want.shape and ours.dtype == TDT[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    limit = ulps * bf16_ulp(float(np.abs(want).max()))
    print(f"\nbf16 elements that differ from {what}: "
          f"{int((got != want).sum())} of {got.size}, max "
          f"{np.abs(got - want).max():.3e} (limit {limit:.3e})")
    np.testing.assert_allclose(got, want, rtol=0, atol=limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_interpreted_fused_kernel(dtype, bf16_dot):
    args = attn_inputs(0)
    ref = jka.spatial_attn_fused(*to_jax(args, dtype), True)
    ours = ka.spatial_attn_kernel_reference(*to_torch(args, dtype))
    assert_close(ours, ref, dtype, "the interpreted K6a")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("force_bqr", [None, 2, 4])
def test_plain_version_matches_interpreted_tiled_kernel(force_bqr, dtype,
                                                        bf16_dot):
    args = attn_inputs(1)
    ref = jka.spatial_attn_tiled(*to_jax(args, dtype), True, force_bqr)
    ours = ka.spatial_attn_kernel_reference(*to_torch(args, dtype))
    assert_close(ours, ref, dtype, f"the interpreted K6b (bqr {force_bqr})")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_matches_the_reference_oracle(dtype):
    args = attn_inputs(2)
    ref = jka._spatial_attn_reference(*to_jax(args, dtype))
    ours = ka.spatial_attn_reference(*to_torch(args, dtype))
    assert_close(ours, ref, dtype, "the reference's oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["fused", "tiled"])
def test_entries_take_the_plain_version_on_cpu_tensors(entry, dtype):
    args = to_torch(attn_inputs(3), dtype)
    before = (ka.spatial_attn_fused.launches, ka.spatial_attn_tiled.launches)
    out = ENTRIES[entry][1](*args)
    assert out.grad_fn is None
    assert torch.equal(out, ka.spatial_attn_kernel_reference(*args))
    with torch.no_grad():           # no graph to build: nothing is saved
        x = args[0].clone().requires_grad_(True)
        assert ENTRIES[entry][1](x, *args[1:]).grad_fn is None
    # the counters count kernel launches: none on CPU tensors
    assert (ka.spatial_attn_fused.launches,
            ka.spatial_attn_tiled.launches) == before
    assert ka.LAUNCHES_PER_CALL == 2


@pytest.mark.parametrize("entry", ["fused", "tiled"])
def test_gradients_match_jax_grad_through_interpreted_entry(entry):
    args = attn_inputs(4, n=2, h=4, w=4, c=8)
    cot = np.random.RandomState(5).randn(*args[0].shape).astype(np.float32)
    jentry, tentry = ENTRIES[entry]

    def loss(*a):
        return (jentry(*a) * jnp.asarray(cot)).sum()

    ref = jax.grad(loss, argnums=tuple(range(6)))(*to_jax(args))
    leaves = [a.requires_grad_(True) for a in to_torch(args)]
    out = tentry(*leaves)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for name, g, r in zip(("x", "wq", "wk", "wv", "wo", "gamma"), grads, ref):
        assert float(np.abs(np.asarray(r)).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_backward_equals_unchunked(monkeypatch, dtype):
    """The recompute walks the frames in chunks: dx is the same bits; the
    weight gradients, added over the chunks in f32 and cast once, agree to
    the dtype's rounding."""
    args = to_torch(attn_inputs(6, n=5), dtype)
    cot = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        7)).to(TDT[dtype])

    def grads():
        leaves = [a.clone().requires_grad_(True) for a in args]
        return torch.autograd.grad(ka.spatial_attn_fused(*leaves), leaves, cot)

    whole = grads()
    monkeypatch.setattr(ka, "BWD_CHUNK_ELEMS", 2 * 64 * 16)   # 2 frames
    chunked = grads()
    assert torch.equal(whole[0], chunked[0])
    for a, w, c in zip(args[1:], whole[1:], chunked[1:]):
        assert c.dtype == a.dtype and c.shape == a.shape
        scale = float(w.float().abs().max())
        tol = 1e-6 * scale if dtype == "float32" else 2 * bf16_ulp(scale)
        assert float((w.float() - c.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gamma_zero_gives_x_back_bit_for_bit(dtype):
    args = to_torch(attn_inputs(8, gamma=0.0), dtype)
    for fn in (ka.spatial_attn_kernel_reference, ka.spatial_attn_fused,
               ka.spatial_attn_tiled):
        assert torch.equal(fn(*args), args[0])


def test_entries_refuse_what_they_do_not_take():
    args = to_torch(attn_inputs(9))
    x = args[0]
    with pytest.raises(ValueError, match="does not divide H"):
        ka.spatial_attn_tiled(*args, force_bqr=3)       # H = 8
    with pytest.raises(ValueError, match="does not divide H"):
        ka.spatial_attn_tiled(*args, force_bqr=0)
    for fn in (ka.spatial_attn_fused, ka.spatial_attn_tiled):
        with pytest.raises(ValueError, match="even H and W"):
            fn(x[:, :7], *args[1:])
        with pytest.raises(ValueError, match="even H and W"):
            fn(x[:, :, :5], *args[1:])
        with pytest.raises(ValueError, match="want x"):
            fn(x[0], *args[1:])
        with pytest.raises(ValueError, match="wk has shape"):
            fn(x, args[1], args[2][:, :1], *args[3:])
        with pytest.raises(ValueError, match="wo has shape"):
            fn(x, *args[1:4], args[4].t(), args[5])
        with pytest.raises(ValueError, match="gamma has shape"):
            fn(x, *args[1:5], args[5].reshape(1))
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(*(a.to("meta") for a in args))
        with pytest.raises(ValueError, match="several devices"):
            fn(x.to("meta"), *args[1:])


def test_bf16_oracle_rounds_where_the_kernel_does_not(bf16_dot):
    """`_spatial_attn_reference` rounds q, k, v and the logits to bf16;
    `_attn_kernel` keeps q, k and the logits in f32. Measured on both sides
    with the same inputs: neither is the other in bf16, both within two bf16
    ulps of the output's scale; in f32 they are one function."""
    args = attn_inputs(10)
    jargs, targs = to_jax(args, "bfloat16"), to_torch(args, "bfloat16")
    j_kernel = np.asarray(jka.spatial_attn_fused(*jargs, True), np.float32)
    j_oracle = np.asarray(jka._spatial_attn_reference(*jargs), np.float32)
    t_kernel = ka.spatial_attn_kernel_reference(*targs).float().numpy()
    t_oracle = ka.spatial_attn_reference(*targs).float().numpy()
    limit = 2 * bf16_ulp(float(np.abs(j_kernel).max()))
    for side, kernel, oracle in (("reference", j_kernel, j_oracle),
                                 ("port", t_kernel, t_oracle)):
        gap = np.abs(kernel - oracle)
        print(f"\n{side}: bf16 oracle vs kernel differ at "
              f"{int((gap > 0).sum())} of {gap.size} elements, max "
              f"{gap.max():.3e}, mean {gap.mean():.3e} (limit {limit:.3e})")
        assert 0 < gap.max() <= limit
    f32 = to_torch(args)
    np.testing.assert_allclose(ka.spatial_attn_kernel_reference(*f32).numpy(),
                               ka.spatial_attn_reference(*f32).numpy(),
                               rtol=0, atol=1e-5)
