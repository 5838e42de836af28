"""K3 (spatially blocked ConvGRU forward) and the K1/K3 choice, port vs
dvdgan_tpu: K3's plain version against the reference's Pallas kernel run in
interpret mode under several block plans; gradients through the port's
autograd policy (K2's plain version on the CPU) against `jax.grad` through
the interpreted kernel; `ops/convgru.py`'s shape rule against the
reference's own K1/K3 split at every level of every preset (the port keeps
the 32²-pixel planes over the split with K1, an H100 measurement).

f32: atol 1e-5 (gradients 1e-4: sums over T·B·H·W terms). bf16: atol 2e-2
— the bf16 ulp at |h| ≤ 1 is 2⁻⁸ and errors compound over the recurrence;
at this shape the plain version equals the interpreted kernel bitwise, as
K1's does (asserted below, so a change shows).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dvdgan_tpu.kernels import convgru_blocked as jblk
from dvdgan_tpu.kernels import convgru_seq as jseq
from dvdgan_tpu.utils.config import PRESETS as JPRESETS
from dvdgan_tpu_torch import kernels
from dvdgan_tpu_torch.kernels import convgru_blocked as k3
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.ops import convgru
from dvdgan_tpu_torch.utils.config import PRESETS, Config

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
PLANS = [(1, 2), (2, 3), (1, 3)]     # (batch block, H-block rows) at H = 6


def seq_inputs(seed, t=3, b=2, h=6, w=6, c=8):
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
@pytest.mark.parametrize("plan", PLANS)
def test_k3_plain_matches_interpreted_kernel(dt, plan):
    j, t = as_dtype(seq_inputs(0), dt)
    ours = k3.gru_sequence_blocked_reference(*t)
    ref = jblk.gru_sequence_blocked(*j, True, plan)
    assert ours.dtype == TDT[dt] and ours.shape == tuple(ref.shape)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=TOL[dt])
    if dt == "bf16":
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_k3_entry_takes_plain_version_on_cpu():
    """On CPU tensors the entry is the plain version (K1's function), for
    the hoisted conv's channel slices too, and counts no launch."""
    gx, cx, h0, wg, wc = (torch.from_numpy(a) for a in seq_inputs(1))
    gcx = torch.cat([gx, cx], dim=-1)
    c = h0.shape[-1]
    before = kernels.gru_sequence_blocked.launches
    out = kernels.gru_sequence_blocked(gcx[..., :2 * c], gcx[..., 2 * c:], h0,
                                       wg, wc)
    assert kernels.gru_sequence_blocked.launches == before
    torch.testing.assert_close(out, k1.gru_sequence_reference(
        gx, cx, h0, wg, wc), rtol=0, atol=0)
    assert k3.gru_sequence_blocked_reference is k1.gru_sequence_reference
    with pytest.raises(ValueError, match="wc has shape"):
        kernels.gru_sequence_blocked(gx, cx, h0, wg, wc[:, :, :, :-1])
    with torch.no_grad():     # no graph, so nothing is saved
        assert kernels.gru_sequence_blocked(
            gx, cx, h0, wg.requires_grad_(), wc).grad_fn is None


def test_k3_gradients_match_interpreted_kernel():
    """The port's policy (inputs and hs saved, K2 backwards) against
    jax.grad through the interpreted Pallas kernel's custom VJP, f32."""
    arrays = seq_inputs(2, t=3, b=1, h=4, w=4, c=4)
    up = np.random.RandomState(3).randn(3, 1, 4, 4, 4).astype(np.float32)

    def loss(*a):
        return jnp.vdot(jblk.gru_sequence_blocked(*a, True, (1, 2)), up)

    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    hs = kernels.gru_sequence_blocked(*leaves)
    got = torch.autograd.grad((hs * torch.from_numpy(up)).sum(), leaves)
    for name, g, w in zip(("gx", "cx", "h0", "wg", "wc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)


def preset_levels(name):
    """(H, W, C) of every GRU level of a preset, from the port's configs
    (its presets are the reference's, checked below)."""
    g = Config(**PRESETS[name]).g_config()
    return [(g.base_res * 2 ** i,) * 2 + (g.level_channels(i)[0],)
            for i in range(g.n_levels)]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_k1_k3_rule_against_the_reference_split(preset):
    """K1 takes every plane the reference's whole-plane kernel holds (its
    VMEM fit at bf16, whatever the batch); of the larger planes K3 takes
    those of 64² pixels and up — also the one the reference's K3 cannot
    hold either and scans (128²×64 at 256 px) — and the 32²-pixel ones
    stay with K1."""
    assert PRESETS[preset] == JPRESETS[preset]
    levels = preset_levels(preset)
    assert levels
    for h, w, c in levels:
        for b in (1, 2, 8, 16):
            # the reference's split: 65 536 elements per sample
            over_split = not jseq.fits_vmem(b, h, w, c, 2)
            assert over_split == (h * w * c > 65536)
            assert convgru.uses_blocked(h, w) == (
                over_split and h * w >= 64 * 64), (h, w, c, b)
    k3_levels = [lv for lv in levels if convgru.uses_blocked(*lv[:2])]
    assert k3_levels == {"kinetics_256_48f": [(64, 64, 128), (128, 128, 64)],
                         "kinetics_128": [(64, 64, 64)]}.get(preset, [])
    if preset == "kinetics_256_48f":
        assert not jblk.fits(2, 128, 128, 64, 2)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_convgru_sends_each_level_to_its_kernel(preset, monkeypatch):
    """`ops/convgru.convgru` calls `gru_sequence_blocked` for the planes
    over the boundary and `gru_sequence_fused` for the rest (recorded on
    stand-ins: no plane of this size is computed here)."""
    called = []

    def stand_in(name):
        def entry(gx, cx, h0, wg, wc):
            called.append(name)
            return cx
        return entry

    monkeypatch.setattr(kernels, "gru_sequence_fused", stand_in("k1"))
    monkeypatch.setattr(kernels, "gru_sequence_blocked", stand_in("k3"))
    monkeypatch.setattr(convgru.layers, "conv2d", lambda p, x: x.new_zeros(
        (*x.shape[:-1], p["w"].shape[-1])))
    for h, w, c in preset_levels(preset):
        called.clear()
        p = {k: {"w": torch.zeros(3, 3, c, n), "b": torch.zeros(n)}
             for k, n in (("gates_x", 2 * c), ("gates_h", 2 * c),
                          ("cand_x", c), ("cand_h", c))}
        x = torch.zeros(1, 1, h, w, c)
        out = convgru.convgru(p, x, time_major=True)
        assert out.shape == x.shape
        big = h * w * c > 65536 and h >= 64
        assert called == ["k3" if big else "k1"], (h, w, c)
