"""K6 over every shape the reference's Pallas kernels take, on the CPU.

The reference routes a spatial pass to K6a where `fits_vmem` admits it and
to K6b where `fits_tiled` does (`dvdgan_tpu/ops/attention.py`). The port's
kernel takes each of those shapes:

  * `plan` gives a plan for every (G level, width, dtype) of the 64, 128 and
    256 px width schedules at ch 16-128 (c8 = C/8, c2 = C/2) that either
    gate admits: 166 cases, none refused. Odd H and forced tiles that do not
    fit still raise;
  * the 4² map (4 keys) runs with k and v padded by zero tokens to 16 keys
    and the padded logits set to −inf; narrow widths (c8 ∉ 8ℕ, c2 ∉ 16ℕ,
    bf16 C % 32 == 16) run on zero-padded weights (and x). `padded_view`
    is that computation on the CPU: it equals the plain version within the
    K6 tolerances and the interpreted K6a/K6b of the reference (`interpret=
    True`, the bf16 `dot` shim of `tests/test_torch_port_attn.py`), as does
    the plain version itself at those shapes;
  * mode 4 (`rows_wide_sweep`, and on 32² maps `rows_wide_resident`, which
    forms each logit once with the sweeps' sums), the wide widths on maps of
    more than 64 keys: `_wide_sweep_view` (q and the logits in passes of 32
    q channels, attn·v in passes of 64 o channels summed over blocks of 64
    keys, o·Wo in passes of 128 o channels) against the plain version with
    3×TF32 logits; the ring of tiles the CTA's warps share moves no sum;
  * the attention op on 4² frames, and G at the repo's test scale with its
    attention at 16²×48 (c8 6, c2 24, C % 32 == 16), `attn_fused="on"`
    against the reference's interpreted Pallas route and against `"off"`
    (G's attention sits after an upsampling level, 8² and up, in both
    packages: `--attn_res 4` is no model's).

The kernel itself runs only on a card (`tests/test_torch_port_gpu.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import attention_spatial as jka
from dvdgan_tpu.models import DSConfig as JDSConfig
from dvdgan_tpu.models import DTConfig as JDTConfig
from dvdgan_tpu.models import GConfig as JGConfig
from dvdgan_tpu.ops import attention as jattn
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.train import step as jstep
from dvdgan_tpu_torch import interop
from dvdgan_tpu_torch.kernels import attention_spatial as ka
from dvdgan_tpu_torch.models import GConfig
from dvdgan_tpu_torch.ops import attention
from dvdgan_tpu_torch.train import step
from test_torch_port_attn import bf16_dot, to_jax, to_torch  # noqa: F401
from test_torch_port_attn_route import (count_fused_forwards,  # noqa: F401
                                        fused_reference, interpreted)
from test_torch_port_k6_tc import assert_bf16_close, unit_gain_inputs
from test_torch_port_longclip import flat_np, tt

# G's channel multiplier at each level from 4×4 up (`models/config.py`)
G_MULTS = {64: (8, 8, 4, 2, 1), 128: (16, 16, 8, 4, 2, 1),
           256: (16, 16, 8, 8, 4, 2, 1)}
CHS = (16, 32, 48, 64, 96, 128)
DTYPES = {"bfloat16": (torch.bfloat16, 2), "float32": (torch.float32, 4)}


def levels(img: int, ch: int):
    """(res, C) of every G level with res ≤ img / 2."""
    res = 4
    for m in G_MULTS[img]:
        if res <= img // 2:
            yield res, ch * m
        res *= 2


def reference_admits(res: int, c: int, itemsize: int) -> bool:
    return (jka.fits_vmem(res, res, c, itemsize, c // 8, c // 2)
            or jka.fits_tiled(res, res, c, itemsize, c // 8, c // 2))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ch", CHS)
@pytest.mark.parametrize("img", list(G_MULTS))
def test_plan_takes_every_level_the_reference_admits(img, ch, dtype):
    tdt, itemsize = DTYPES[dtype]
    for res, c in levels(img, ch):
        if not reference_admits(res, c, itemsize):
            continue
        p = ka.plan(tdt, 2, res, res, c, c // 8, c // 2)
        assert p.smem_bytes <= ka.MAX_SMEM_BYTES
        assert (p.c, p.c8, p.c2) >= (c, c // 8, c // 2)
        assert (res * res) % p.tq == 0 and p.items == 2 * res * res // p.tq


def test_the_grid_holds_166_admitted_cases_and_none_refused():
    admitted = refused = 0
    for img in G_MULTS:
        for ch in CHS:
            for tdt, itemsize in DTYPES.values():
                for res, c in levels(img, ch):
                    if not reference_admits(res, c, itemsize):
                        continue
                    admitted += 1
                    try:
                        ka.plan(tdt, 2, res, res, c, c // 8, c // 2)
                    except ValueError:
                        refused += 1
    assert (admitted, refused) == (166, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_still_raises_for_odd_maps_and_unfit_tiles(dtype):
    for h, w in ((5, 4), (4, 7)):
        with pytest.raises(ValueError, match="even H and W"):
            ka.plan(dtype, 2, h, w, 64, 8, 32)
    with pytest.raises(ValueError, match="does not take"):
        ka.plan(dtype, 2, 4, 4, 256, 32, 128, force_tq=32)   # 16 queries
    with pytest.raises(ValueError, match="does not take"):
        ka.plan(dtype, 2, 32, 32, 1024, 128, 512, force_tq=1024)
    with pytest.raises(ValueError, match="does not take"):
        ka.plan(dtype, 2, 8, 8, 64, 8, 32, force_tq=24)      # not 16·k


@pytest.mark.parametrize("h,c,mode,warps", [
    (4, 128, 1, 1), (4, 512, 3, 1), (4, 2048, 3, 1), (8, 1536, 3, 4),
    (16, 768, 3, 8), (32, 384, 4, 8), (32, 1024, 4, 8), (64, 384, 4, 4)])
def test_bf16_plan_picks_the_body_and_warps_that_fit(h, c, mode, warps):
    """The 4² map (keys padded to 16) in the narrow sweep or the wide body;
    the wide widths in the wide body (≤ 64 keys) or the wide sweep, with as
    many warps a CTA (16 query rows each, all on one work item) as their
    buffers fit beside the ring of tiles the warps share."""
    p = ka.plan(torch.bfloat16, 4, h, h, c, c // 8, c // 2)
    assert ka.BODIES[p.body][0] == mode and p.tq == 16 * warps
    kvn = ka.keys_padded(h * h // 4)
    if mode == 3:
        assert p.smem_bytes == ka._wide_smem(kvn, c, c // 8, c // 2, warps)
    if mode == 4:
        assert p.smem_bytes == ka._wide_sweep_smem(kvn, c, c // 8, c // 2,
                                                   warps)
        assert ka._wide_sweep_smem(kvn, c, c // 8, c // 2,
                                   2 * warps) > ka.MAX_SMEM_BYTES or (
            2 * warps > ka.BODIES[p.body][2])


def test_wide_bodies_fit_shared_memory_at_every_admitted_case():
    """Over the 166 cases of the grid above, every one that takes mode 3 or
    4 (the wide bodies) asks for at most 232,448 bytes of shared memory a
    CTA: each warp's buffers and a ring of 3 to 8 tiles of 10,240 bytes,
    as many as fit, with two 8-byte barriers for each of 8 stages and a
    16-byte entry for each tile of a work item."""
    modes = {3: 0, 4: 0}
    for img in G_MULTS:
        for ch in CHS:
            for res, c in levels(img, ch):
                if not reference_admits(res, c, 2):
                    continue
                p = ka.plan(torch.bfloat16, 2, res, res, c, c // 8, c // 2)
                mode = ka.BODIES[p.body][0]
                if mode < 3:
                    continue
                modes[mode] += 1
                kvn, warps = ka.keys_padded(res * res // 4), p.tq // 16
                layout = ka._wide_smem if mode == 3 else ka._wide_sweep_smem
                assert p.smem_bytes == layout(kvn, p.c, p.c8, p.c2, warps)
                attn = 32 * kvn if kvn != 256 else 0
                own = warps * (32 * (p.c2 + 8) if mode == 3 else
                               max(128 * p.c8, 32 * (p.c2 + 8)) + attn)
                table = 16 * ka.wide_tiles(mode, kvn, p.c, p.c8, p.c2)
                stages, rest = divmod(p.smem_bytes - own - 128 - table,
                                      10240)
                assert rest == 0 and 3 <= stages <= 8, (res, c, stages)
                assert p.smem_bytes <= 232448, (res, c)
    assert modes[3] > 0 and modes[4] > 0, modes


@pytest.mark.parametrize("c,c8,c2,widths", [
    (32, 4, 16, {"bfloat16": (32, 8, 16), "float32": (32, 8, 16)}),
    (96, 12, 48, {"bfloat16": (96, 16, 48), "float32": (96, 16, 48)}),
    (72, 9, 36, {"bfloat16": (96, 16, 48), "float32": (80, 16, 48)}),
    (48, 6, 24, {"bfloat16": (64, 8, 32), "float32": (48, 8, 32)})])
def test_plan_pads_narrow_widths(c, c8, c2, widths):
    for name, (tdt, _) in DTYPES.items():
        p = ka.plan(tdt, 2, 32, 32, c, c8, c2)
        assert (p.c, p.c8, p.c2) == widths[name]


def padded_view(x, wq, wk, wv, wo, gamma, logits=torch.matmul):
    """What the kernel computes for a plan that pads: the weights (and x
    where C is padded) zero-padded to `plan`'s widths as `_forward` pads
    them, k and v over the frame's tokens padded by zero tokens to
    `keys_padded`, the padded keys' logits −inf; the plain version's
    roundings."""
    n, h, w, c = x.shape
    c8, c2 = wq.shape[1], wv.shape[1]
    p = ka.plan(x.dtype, n, h, w, c, c8, c2)
    pad = torch.nn.functional.pad
    dc, d8, d2 = p.c - c, p.c8 - c8, p.c2 - c2
    wq, wk = pad(wq, (0, d8, 0, dc)), pad(wk, (0, d8, 0, dc))
    wv, wo = pad(wv, (0, d2, 0, dc)), pad(wo, (0, dc, 0, d2))
    xp = pad(x, (0, dc))
    dt = x.dtype
    wq, wk, wv, wo = (a.to(dt).float() for a in (wq, wk, wv, wo))
    keys = (h // 2) * (w // 2)
    xt = xp.reshape(n, h * w, p.c).float()
    kv = pad(ka._pool_tokens(xp).float(), (0, 0, 0, ka.keys_padded(keys)
                                           - keys))
    k = kv @ wk
    v = (kv @ wv).to(dt)
    lg = logits(xt @ wq, k.transpose(1, 2))
    lg[..., keys:] = -torch.inf
    attn = torch.softmax(lg, dim=-1).to(dt)
    o = (attn.float() @ v.float()).to(dt)
    out = (xt + gamma.float() * (o.float() @ wo)).to(dt)
    return out[..., :c].reshape(x.shape)


# 4² maps (4 keys: padded to 16) at C 64, 256 and 512; c8 ∉ 8ℕ and c2 ∉
# 16ℕ (C 72: 9, 36; C 96: 12, 48; C 32: 4, 16); bf16 C % 32 == 16 (C 48)
PADDED = [(2, 4, 4, 64), (2, 4, 4, 256), (1, 4, 4, 512), (2, 8, 8, 72),
          (2, 8, 8, 96), (2, 8, 8, 32), (2, 8, 8, 48)]


@pytest.mark.parametrize("n,h,w,c", PADDED)
def test_padded_view_equals_the_plain_version_in_f32(n, h, w, c):
    args = to_torch(unit_gain_inputs(11, n, h, w, c))
    torch.testing.assert_close(padded_view(*args),
                               ka.spatial_attn_kernel_reference(*args),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,h,w,c", PADDED)
def test_padded_view_meets_the_bf16_tolerance(n, h, w, c):
    args = to_torch(unit_gain_inputs(12, n, h, w, c), "bfloat16")
    assert_bf16_close(padded_view(*args, logits=ka.logits_3xtf32),
                      ka.spatial_attn_kernel_reference(
                          *args, logits=ka.logits_3xtf32),
                      "the plain version (3×TF32)")


@pytest.mark.parametrize("entry", ["fused", "tiled"])
@pytest.mark.parametrize("n,h,w,c", PADDED)
def test_plain_and_padded_views_match_the_interpreted_kernels(
        n, h, w, c, entry, bf16_dot):
    """Against K6a, and K6b with 2 image rows a query tile, interpreted;
    f32 within 1e-5, bf16 one ulp on at most 0.5% of the elements."""
    args = unit_gain_inputs(13, n, h, w, c)
    jfn = (jka.spatial_attn_fused if entry == "fused"
           else lambda *a: jka.spatial_attn_tiled(*a, 2))
    for dtype in ("float32", "bfloat16"):
        ref = torch.from_numpy(np.asarray(jfn(*to_jax(args, dtype), True),
                                          np.float32))
        ours = to_torch(args, dtype)
        plain = ka.spatial_attn_kernel_reference(*ours)
        view = padded_view(*ours)
        if dtype == "float32":
            for got in (plain, view):
                torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
        else:
            assert_bf16_close(plain, ref, f"the interpreted K6 ({entry})")
            assert_bf16_close(view, ref, f"the interpreted K6 ({entry})")


def _wide_sweep_view(x, wq, wk, wv, wo, gamma):
    """Mode 4's passes (see the module doc) on one frame batch, bf16."""
    n, h, w, c = x.shape
    dt = x.dtype
    wq, wk, wv, wo = (a.to(dt).float() for a in (wq, wk, wv, wo))
    c8, c2 = wq.shape[1], wv.shape[1]
    xt = x.reshape(n, h * w, c).float()
    kv = ka._pool_tokens(x).float()
    k = kv @ wk
    v = (kv @ wv).to(dt).float()
    lg = torch.zeros(n, h * w, k.shape[1])
    for lo in range(0, c8, 32):
        lg += ka.logits_3xtf32(xt @ wq[:, lo:lo + 32],
                               k[..., lo:lo + 32].transpose(1, 2))
    attn = torch.softmax(lg, dim=-1).to(dt).float()
    keys = attn.shape[-1]
    y = torch.zeros(n, h * w, c)
    o = torch.zeros(n, h * w, c2)
    for lo in range(0, c2, 64):
        for k0 in range(0, keys, 64):
            o[..., lo:lo + 64] += (attn[..., k0:k0 + 64]
                                   @ v[:, k0:k0 + 64, lo:lo + 64])
    o = o.to(dt).float()
    for lo in range(0, c2, 128):
        y += o[..., lo:lo + 128] @ wo[lo:lo + 128]
    return (xt + gamma.float() * y).to(dt).reshape(x.shape)


@pytest.mark.parametrize("n,h,w,c", [(1, 32, 32, 384), (1, 32, 32, 512)])
def test_wide_sweep_view_matches_the_plain_version_with_3xtf32_logits(n, h,
                                                                      w, c):
    args = to_torch(unit_gain_inputs(14, n, h, w, c), "bfloat16")
    assert ka.BODIES[ka.plan(torch.bfloat16, n, h, w, c, c // 8,
                             c // 2).body][0] == 4
    assert_bf16_close(_wide_sweep_view(*args),
                      ka.spatial_attn_kernel_reference(
                          *args, logits=ka.logits_3xtf32),
                      "the plain version (3×TF32)")


# ------------------------------------- the op at 4², G at narrow widths ---

@pytest.mark.parametrize("c", [32, 256])
def test_separable_attn_on_a_4x4_map_matches_reference_pallas_route(
        monkeypatch, c):
    """The attention op on 4² frames (4 keys) through the fused entry
    against the reference's `separable_attn` on its interpreted Pallas
    route, and against "off". (G places its attention after an upsampling
    level, 8² and up: no model runs it on the 4² seed map, in either
    package.)"""
    p = jattn.separable_attn_init(jax.random.PRNGKey(9), c)
    p = {k: dict(v, gamma=jnp.float32(g)) for (k, v), g in
         zip(p.items(), (0.7, -0.4))}
    x = np.random.RandomState(10).randn(2, 3, 4, 4, c).astype(np.float32)
    hits = interpreted(monkeypatch)
    ref = jattn.separable_attn(p, jnp.asarray(x), use_pallas=True)
    assert hits == {"fused": 1, "tiled": 0}
    calls = count_fused_forwards(monkeypatch)
    ours = attention.separable_attn(tt(p), torch.from_numpy(x), "on")
    assert calls == ["spatial_attn_fused"]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    off = attention.separable_attn(tt(p), torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), off.numpy(), atol=1e-5)


# attention at 16×16×48: c8 6 ∉ 8ℕ, c2 24 ∉ 16ℕ, and C % 32 == 16 (on the
# card: zero-padded weights, and x padded in bf16)
GN_KW = dict(img_size=32, n_frames=4, ch=12, z_dim=120, n_classes=5,
             emb_dim=16, attn_res=16)


def gn_state(seed: int) -> dict:
    """A reference train state for GN_KW: G's weights and EMA perturbed
    off the init, both attention γ ≠ 0, BN stats non-trivial."""
    s = jstate.create(jax.random.PRNGKey(seed), JGConfig(**GN_KW),
                      JDSConfig(img_size=32, ch=8, n_classes=5, k_frames=2),
                      JDTConfig(img_size=32, n_frames=4, ch=8, n_classes=5),
                      jstate.TrainConfig(d_steps=2, ema_start=0))
    rng = np.random.RandomState(seed)

    def perturb(a, scale=0.05):
        a = np.asarray(a)
        return (a + scale * rng.randn(*a.shape)).astype(a.dtype)

    s["g"]["params"] = jax.tree.map(perturb, s["g"]["params"])
    s["g"]["params"]["attn"]["spatial"]["gamma"] = np.float32(0.6)
    s["g"]["params"]["attn"]["temporal"]["gamma"] = np.float32(-0.5)
    s["g"]["stats"] = jax.tree.map(
        lambda a: np.abs(perturb(a, 0.1)), s["g"]["stats"])
    s["g_ema"] = jax.tree.map(perturb, s["g"]["params"])
    return s


def test_sample_with_narrow_attention_fused_matches_reference(
        fused_reference, monkeypatch):
    """G with its spatial attention at 16²×48 through the fused entry:
    against the reference on its interpreted Pallas route (atol 1e-4,
    `test_torch_port_sample.py`'s) and against the port's "off"."""
    js = gn_state(3)
    rng = np.random.RandomState(4)
    z = rng.randn(3, GN_KW["z_dim"]).astype(np.float32)
    y = np.array([0, 4, 2], np.int32)
    ref = jax.jit(functools.partial(jstep.sample, g_cfg=JGConfig(**GN_KW)))(
        js["g_ema"], js["g"]["stats"], js["g"]["sn_u"], jnp.asarray(z),
        jnp.asarray(y))
    assert fused_reference["fused"] == 1

    state = interop.load_train_state(flat_np(js))
    assert state["g_ema"]["attn"]["spatial"]["theta"]["w"].shape == (48, 6)
    calls = count_fused_forwards(monkeypatch)
    args = (state["g_ema"], state["g"]["stats"], state["g"]["sn_u"],
            torch.from_numpy(z), torch.from_numpy(y).long())
    ours = step.sample(*args, GConfig(**GN_KW, attn_fused="on"))
    assert calls == ["spatial_attn_fused"]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    off = step.sample(*args, GConfig(**GN_KW))
    assert len(calls) == 1
    np.testing.assert_allclose(ours.numpy(), off.numpy(), rtol=0, atol=1e-5)
