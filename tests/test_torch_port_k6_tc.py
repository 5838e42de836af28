"""K6's bf16 body on Hopper (`csrc/attention_spatial.cu`), what the CPU can
hold of it:

  (a) its logits. The kernel forms q kᵀ on the tensor cores as 3×TF32: each
      f32 operand v split into hi = tf32(v) (round to nearest, ties away,
      `cvt.rna`) and lo = tf32(v − hi), then hi·hi + hi·lo + lo·hi with f32
      sums. `logits_3xtf32` emulates that on the bit patterns. Held here:
      the rounding itself; the logits against f64 within
      LOGIT_BOUND · Σ_d |q_d k_d| (3·2⁻²² from the split, c8·2⁻²⁴ from f32
      sums) at the statistics of the driven calls (unit-gain projections at
      C 64 and 256, x ~ N(0, 1), as `chip_smoke.k6_inputs` draws them), where
      plain TF32 falls outside it; and the whole bf16 output of the plain
      version with these logits against the plain version and against the
      interpreted JAX kernels: within one bf16 ulp of the output's scale on
      at most 0.5% of the elements (the tolerance `chip_smoke.py` holds the
      card to).
  (b) its `plan`: every driven call gets one within 227 KB of shared memory,
      the persistent grid and the body the shape needs (mode 2, vᵀ and k
      read from L2, where they do not fit); what the kernel does not take
      is refused; `force_bqr` gives the query tile it gave before.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from dvdgan_tpu.kernels import attention_spatial as jka
from dvdgan_tpu_torch.kernels import attention_spatial as ka
from test_torch_port_attn import bf16_dot, to_jax, to_torch  # noqa: F401

LOGIT_BOUND = 2.0 ** -18
DIFFER_LIMIT = 0.005          # share of bf16 output elements that may differ
# (N, H, W, C) of every call on the driven paths (`chip_smoke.K6A_SHAPES`,
# `K6B_SHAPES`)
DRIVEN = [(256, 32, 32, 64), (128, 32, 32, 64), (384, 32, 32, 256),
          (96, 32, 32, 256), (192, 64, 64, 64), (96, 64, 64, 64)]


def unit_gain_inputs(seed, n, h, w, c, gamma=0.7):
    """(x, wq, wk, wv, wo, γ) as f32 numpy arrays: x ~ N(0, 1), each
    projection N(0, 1/fan_in), as the chip run draws them."""
    rng = np.random.RandomState(seed)

    def proj(a, b):
        return (a ** -0.5 * rng.randn(a, b)).astype(np.float32)

    return (rng.randn(n, h, w, c).astype(np.float32), proj(c, c // 8),
            proj(c, c // 8), proj(c, c // 2), proj(c // 2, c),
            np.float32(gamma))


def bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def q_and_kt(x, wq, wk):
    """The kernel's q and kᵀ: f32 sums of the bf16 operands' products."""
    n, h, w, c = x.shape
    xb, wqb, wkb = (a.to(torch.bfloat16).float() for a in (x, wq, wk))
    q = xb.reshape(n, h * w, c) @ wqb
    kv = ka._pool_tokens(xb)
    return q, (kv @ wkb).transpose(1, 2)


def test_tf32_rna_rounds_to_nearest_ties_away():
    rng = np.random.RandomState(0)
    bits = rng.randint(0x00800000, 0x7f000000, 4000).astype(np.int64)
    bits[:6] = [0x3f801000, 0x3f800fff, 0x3f801001, 0x3f803000, 0x3f7ff000,
                0x3f802000]                  # ties, below and above a tie
    bits = np.concatenate([bits, bits | (1 << 31)])       # both signs
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy())
    got = ka.tf32_rna(x).numpy().view(np.uint32).astype(np.int64)
    # the magnitude to the nearest multiple of 2^13, a tie up (away from 0)
    mag = bits & 0x7fffffff
    want = (bits & (1 << 31)) | ((mag + 0x1000) // 0x2000 * 0x2000)
    np.testing.assert_array_equal(got, want)
    assert (got & 0x1fff == 0).all()
    ties = got[[0, 3, 4, 4000, 4003, 4004]] & 0x7fffffff
    assert list(ties) == [0x3f802000, 0x3f804000, 0x3f800000] * 2


@pytest.mark.parametrize("c", [64, 256])
def test_3xtf32_logits_within_bound_of_f64(c):
    args = to_torch(unit_gain_inputs(1, 2, 32, 32, c))
    q, kt = q_and_kt(*args[:3])
    exact = q.double() @ kt.double()
    scale = q.abs().double() @ kt.abs().double()
    got = ka.logits_3xtf32(q, kt).double()
    rel = ((got - exact).abs() / scale).max().item()
    # one TF32 product alone (hi·hi) is what the contract rules out
    one = (ka.tf32_rna(q) @ ka.tf32_rna(kt)).double()
    rel_one = ((one - exact).abs() / scale).max().item()
    print(f"\nC {c}: 3xTF32 max |err| / Σ|qk| {rel:.2e} (bound "
          f"{LOGIT_BOUND:.2e}); 1xTF32 {rel_one:.2e}; f32 "
          f"{((q @ kt).double() - exact).abs().div(scale).max().item():.2e}")
    assert rel <= LOGIT_BOUND < rel_one


def assert_bf16_close(ours: torch.Tensor, ref: torch.Tensor, what: str):
    got, want = ours.float(), ref.float()
    limit = bf16_ulp(float(want.abs().max()))
    differ = int((got != want).sum())
    print(f"\nbf16 elements that differ from {what}: {differ} of "
          f"{got.numel()}, max {float((got - want).abs().max()):.3e} "
          f"(limit {limit:.3e})")
    torch.testing.assert_close(got, want, rtol=0, atol=limit)
    assert differ <= DIFFER_LIMIT * got.numel()


@pytest.mark.parametrize("n,h,w,c", [(2, 32, 32, 64), (1, 32, 32, 256),
                                     (1, 64, 64, 64)])
def test_plain_version_with_3xtf32_logits_meets_the_bf16_tolerance(n, h, w,
                                                                   c):
    args = to_torch(unit_gain_inputs(2, n, h, w, c), "bfloat16")
    ours = ka.spatial_attn_kernel_reference(*args, logits=ka.logits_3xtf32)
    assert_bf16_close(ours, ka.spatial_attn_kernel_reference(*args),
                      "the plain version with f32 logits")


@pytest.mark.parametrize("entry", ["fused", "tiled"])
def test_3xtf32_plain_version_matches_interpreted_kernels(entry, bf16_dot):
    args = unit_gain_inputs(3, 2, 8, 8, 64)
    jfn = (jka.spatial_attn_fused if entry == "fused"
           else lambda *a: jka.spatial_attn_tiled(*a, 2))
    ref = torch.from_numpy(np.asarray(
        jfn(*to_jax(args, "bfloat16"), True), np.float32))
    ours = ka.spatial_attn_kernel_reference(*to_torch(args, "bfloat16"),
                                            logits=ka.logits_3xtf32)
    assert ours.dtype == torch.bfloat16
    assert_bf16_close(ours, ref, f"the interpreted K6{entry[0]}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", DRIVEN)
def test_every_driven_call_gets_a_plan_within_shared_memory(dtype, n, h, w,
                                                            c):
    plan = ka.plan(dtype, n, h, w, c, c // 8, c // 2)
    hw, kvn = h * w, h * w // 4
    assert plan.smem_bytes <= ka.MAX_SMEM_BYTES
    assert hw % plan.tq == 0 and plan.items == n * hw // plan.tq
    if dtype == torch.float32:     # the first version's body and tile
        assert (plan.body, plan.ctas) == (-1, plan.items)
        assert plan.tq == (64 if h == 32 else 32)
        return
    mode, ot, warps = ka.BODIES[plan.body]
    assert mode == (0 if kvn == ka.RES_KEYS else 1)
    assert c // 2 <= 8 * ot and c // 8 <= 2 * ot
    # the most queries the body takes; one CTA an SM on every driven call
    assert plan.tq == 16 * warps
    assert plan.ctas == min(plan.items, ka.SMS)
    assert plan.smem_bytes == (2 * ((c // 8) * (c + 32) + c * (c // 2 + 8)
                                    + (c // 2) * (kvn + 8))
                               + 8 * (c // 8) * kvn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_refuses_what_the_kernel_does_not_take(dtype):
    """Odd H still raises. The shapes once refused (c8 = 9, 4 keys, c2 =
    24; in bf16 C % 32 == 16 and 32²×384) now get a plan at the widths the
    wrapper zero-pads them to, 4 keys padded to 16 in the kernel
    (`tests/test_torch_port_k6_domain.py`)."""
    with pytest.raises(ValueError, match="does not take"):
        ka.plan(dtype, 2, 7, 8, 64, 8, 32)         # odd H
    bf16 = dtype == torch.bfloat16
    for shape, widths in [((2, 8, 8, 72, 9, 36),   # c8 = 9
                           (96 if bf16 else 80, 16, 48)),
                          ((2, 4, 4, 64, 8, 32), (64, 8, 32)),   # 4 keys
                          ((2, 8, 8, 64, 8, 24), (64, 8, 32))]:  # c2 = 24
        p = ka.plan(dtype, *shape)
        assert (p.c, p.c8, p.c2) == widths, shape
        assert p.tq == 16 if shape[1] == 4 else p.tq == 64
    # what the bf16 bodies once refused and the CUDA-core body takes: x
    # padded to C % 32 == 0, the wide sweep (mode 4) at 32²×384
    for shape, f32_tq, mode in [((2, 8, 8, 48, 8, 16), 64, 1),
                                ((2, 16, 16, 80, 16, 32), 64, 1),
                                ((2, 32, 32, 384, 48, 192), 64, 4)]:
        p = ka.plan(dtype, *shape)
        if dtype == torch.bfloat16:
            assert ka.BODIES[p.body][0] == mode and p.c % 32 == 0
        else:
            assert p.tq == f32_tq and p.c == shape[3]
    # the 8×8 attention at C 512: both take it, bf16 in its wide body
    # (mode 3, `tests/test_torch_port_k6_wide.py`)
    wide = ka.plan(dtype, 2, 8, 8, 512, 64, 256)
    assert wide.tq == 64
    assert wide.body == (-1 if dtype == torch.float32
                         else ka.BODIES.index((3, 32, 8)))


@pytest.mark.parametrize("n,h,w,c,k_staged", [
    (2, 64, 64, 128, True), (2, 96, 96, 64, True),      # k fits alone
    (2, 64, 64, 256, False), (2, 128, 128, 64, False)])
def test_plan_reads_v_and_k_from_l2_where_they_do_not_fit(n, h, w, c,
                                                          k_staged):
    """Where a frame's split k and vᵀ do not fit shared memory together
    beside the weights, the bf16 plan takes mode 2 (the sweep with vᵀ read
    from L2), whose CTAs stage the weights and, where it fits beside them,
    k; where both fit, never."""
    kvn = h * w // 4
    assert ka._bf16_smem(kvn, c, c // 8, c // 2, True) > ka.MAX_SMEM_BYTES
    plan = ka.plan(torch.bfloat16, n, h, w, c, c // 8, c // 2)
    mode, ot, warps = ka.BODIES[plan.body]
    assert mode == 2 and c // 2 <= 8 * ot and c // 8 <= 2 * ot
    assert plan.tq == 16 * warps
    weights = 2 * ((c // 8) * (c + 32) + c * (c // 2 + 8))
    assert plan.smem_bytes == weights + (8 * (c // 8) * kvn if k_staged
                                         else 0)
    assert plan.smem_bytes <= ka.MAX_SMEM_BYTES
    for shape in DRIVEN + [(2, 48, 48, 128), (2, 16, 16, 256)]:
        p = ka.plan(torch.bfloat16, *shape, shape[3] // 8, shape[3] // 2)
        assert ka.BODIES[p.body][0] != 2, shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_force_bqr_gives_the_query_tile_it_gave_before(dtype):
    """`force_bqr` image rows make force_bqr·W queries a tile, honoured if
    the kernel takes it, refused if not."""
    def tq(h, w, c, bqr):
        force = ka._tile_queries(h, w, bqr)
        return ka.plan(dtype, 4, h, w, c, c // 8, c // 2, force_tq=force).tq

    assert [tq(32, 32, 64, b) for b in (1, 2)] == [32, 64]
    assert tq(24, 24, 64, 2) == 48
    with pytest.raises(ValueError, match="does not take"):
        tq(32, 32, 64, 32)                  # 1024 queries: no fit
    with pytest.raises(ValueError, match="does not take"):
        tq(8, 8, 64, 1)                     # 8 queries: not 16·k
    with pytest.raises(ValueError, match="does not divide H"):
        tq(8, 8, 64, 3)
    if dtype == torch.float32:              # 64 queries of 64² overflow S
        with pytest.raises(ValueError, match="does not take"):
            tq(64, 64, 64, 1)
    else:                                   # a warp per 16 queries
        assert tq(64, 64, 64, 1) == 64
        assert tq(32, 32, 256, 4) == 128
        with pytest.raises(ValueError, match="at most 128"):
            tq(32, 32, 256, 8)              # 256 queries: 16 warps
        assert tq(64, 64, 64, 4) == 256


def test_plan_grid_covers_every_item_once():
    """The grid never exceeds the items (each CTA takes a contiguous range,
    at least one item); a forced grid is clamped to them. The CTAs' ranges
    tile the items as the kernel cuts them."""
    bf16 = torch.bfloat16
    small = ka.plan(bf16, 3, 16, 8, 64, 8, 32)
    assert (small.tq, small.items, small.ctas) == (128, 3, 3)
    forced = ka.plan(bf16, 96, 32, 32, 256, 32, 128, ctas=7)
    assert (forced.items, forced.ctas) == (768, 7)
    assert ka.plan(bf16, 2, 8, 8, 64, 8, 32, ctas=1000).ctas == 2
    # two CTAs an SM where shared memory and registers allow them
    assert ka.plan(bf16, 64, 32, 32, 64, 8, 32, force_tq=64).ctas == 2 * ka.SMS
    for p in (forced, ka.plan(bf16, 192, 64, 64, 64, 8, 32)):
        cuts = [p.items * b // p.ctas for b in range(p.ctas + 1)]
        assert cuts[0] == 0 and cuts[-1] == p.items
        assert all(b - a >= 1 for a, b in zip(cuts, cuts[1:]))
