"""K6's bf16 body for wide attention on small maps (mode 3 of
`csrc/attention_spatial.cu`, `rows_wide`), on the CPU: its view of one
frame's attention and the plan that picks it.

The 8×8 and 16×16 attention of the 128 and 256 px presets (`--attn_res 8`
at C 512: c8 64, c2 256; 16×16 at C 384: c8 48, c2 192) is wider than the
other bf16 bodies hold in a warp's registers (c8 ≤ 32, c2 ≤ 128). Mode 3
keeps a row's ≤ 64 logits in registers and splits the widths instead:
`_wide_view` forms the logits as 3×TF32 in passes of 32 q channels added in
k order; attn·v with o rounded to bf16 (the kernel's passes of 64 o
channels move no rounding); o·Wo as one sum per pass of 128 o channels, the
passes added into f32 totals; out = x + γ·y rounded once. The ring of tiles
through which a CTA's warps share the weights and the frame's k and vᵀ
changes where a warp reads its operands, not these sums. It is held, at the tolerance of
`tests/test_torch_port_k6_tc.py` (one bf16 ulp at the output's scale on at
most 0.5% of the elements), to the plain version with 3×TF32 logits and to
the interpreted JAX kernel `_spatial_attn_pallas` (through
`spatial_attn_fused`). The kernel itself runs only on a card
(`tests/test_torch_port_gpu.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dvdgan_tpu.kernels import attention_spatial as jka
from dvdgan_tpu_torch.kernels import attention_spatial as ka
from test_torch_port_attn import bf16_dot, to_jax, to_torch  # noqa: F401
from test_torch_port_k6_tc import assert_bf16_close, unit_gain_inputs

Q_PASS, O_PASS = 32, 128     # q channels of a logit pass; o channels a pass
WIDE = [(1, 8, 8, 512), (1, 16, 16, 384)]


def _wide_view(x, wq, wk, wv, wo, gamma):
    """One frame batch through mode 3's passes (see the module doc)."""
    n, h, w, c = x.shape
    dt = x.dtype
    wq, wk, wv, wo = (a.to(dt).float() for a in (wq, wk, wv, wo))
    c8, c2 = wq.shape[1], wv.shape[1]
    xt = x.reshape(n, h * w, c).float()
    kv = ka._pool_tokens(x).float()
    k = kv @ wk
    v = (kv @ wv).to(dt).float()
    logits = torch.zeros(n, h * w, k.shape[1])
    for lo in range(0, c8, Q_PASS):
        q = xt @ wq[:, lo:lo + Q_PASS]
        logits += ka.logits_3xtf32(q, k[..., lo:lo + Q_PASS].transpose(1, 2))
    attn = torch.softmax(logits, dim=-1).to(dt).float()
    y = torch.zeros(n, h * w, c)
    for lo in range(0, c2, O_PASS):
        o = (attn @ v[..., lo:lo + O_PASS]).to(dt).float()
        y += o @ wo[lo:lo + O_PASS]
    return (xt + gamma.float() * y).to(dt).reshape(x.shape)


@pytest.mark.parametrize("shape", WIDE, ids=str)
def test_wide_view_matches_the_plain_version_with_3xtf32_logits(shape):
    args = to_torch(unit_gain_inputs(4, *shape), "bfloat16")
    ours = _wide_view(*args)
    assert ours.dtype == torch.bfloat16
    assert_bf16_close(ours, ka.spatial_attn_kernel_reference(
        *args, logits=ka.logits_3xtf32), "the plain version (3×TF32)")


@pytest.mark.parametrize("shape", WIDE, ids=str)
def test_wide_view_matches_the_interpreted_kernel(shape, bf16_dot):
    args = unit_gain_inputs(5, *shape)
    ref = torch.from_numpy(np.asarray(
        jka.spatial_attn_fused(*to_jax(args, "bfloat16"), True), np.float32))
    assert_bf16_close(_wide_view(*to_torch(args, "bfloat16")), ref,
                      "the interpreted K6a")


@pytest.mark.parametrize("n,h,w,c", WIDE + [(96, 8, 8, 512),
                                            (192, 8, 8, 512)])
def test_plan_takes_the_wide_attention_in_bf16(n, h, w, c):
    """The kinetics_128 / 256 px `--attn_res 8` calls (C 512) and 16×16 at
    C 384 take mode 3: the most queries its CTA takes that divide H·W (a
    warp each), its ring of tiles and a warp's o buffer within shared
    memory, and never when a narrower body holds the widths."""
    c8, c2 = c // 8, c // 2
    p = ka.plan(torch.bfloat16, n, h, w, c, c8, c2)
    mode, ot, warps = ka.BODIES[p.body]
    assert mode == 3 and c8 <= 2 * ot and c2 <= 8 * ot
    kvn = h * w // 4
    assert p.tq == min(16 * warps, h * w)
    assert kvn <= ka.WIDE_KEYS
    own = ((p.tq // 16) * 32 * (c2 + 8) + 128     # + the ring's barriers
           + 16 * ka.wide_tiles(3, kvn, c, c8, c2))  # and its tile table
    stages = (p.smem_bytes - own) // 10240
    assert p.smem_bytes == own + stages * 10240
    share = 233472 // (8 // (p.tq // 16)) - 1024
    if share >= ka.MAX_SMEM_BYTES or own + 3 * 10240 > share:
        share = ka.MAX_SMEM_BYTES
    assert stages == min(8, max(3, (share - own) // 10240))
    assert p.smem_bytes <= ka.MAX_SMEM_BYTES
    for narrow in [(2, 8, 8, 256), (2, 16, 16, 256), (2, 8, 8, 128)]:
        q = ka.plan(torch.bfloat16, *narrow, narrow[3] // 8, narrow[3] // 2)
        assert ka.BODIES[q.body][0] != 3, narrow


def test_plan_still_refuses_what_no_bf16_body_takes():
    """What no bf16 body took before now has one: C % 32 == 16 through x
    padded to the next 32 channels, the 4² map (keys padded to 16) and c8
    over 64 or c2 % 32 == 16 in the wide body's passes (c2 padded to 32),
    256 keys at C 384 in the wide sweep. An odd H still raises."""
    for shape, mode, c, c2 in [
            ((2, 16, 16, 80, 16, 32), 1, 96, 32),     # C % 32 == 16
            ((2, 8, 8, 48, 8, 16), 1, 64, 16),
            ((2, 4, 4, 512, 64, 256), 3, 512, 256),   # 4 keys
            ((2, 32, 32, 384, 48, 192), 4, 384, 192),  # 256 keys at C 384
            ((2, 8, 8, 576, 72, 288), 3, 576, 288),   # c8 over 64
            ((2, 8, 8, 544, 64, 272), 3, 544, 288)]:  # c2 % 32 == 16
        p = ka.plan(torch.bfloat16, *shape)
        assert (ka.BODIES[p.body][0], p.c, p.c2) == (mode, c, c2), shape
        assert p.smem_bytes <= ka.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="does not take"):
        ka.plan(torch.bfloat16, 2, 9, 8, 512, 64, 256)
