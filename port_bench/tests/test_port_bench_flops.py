"""The benchmark's model-FLOP count from shapes against PyTorch's own
count (`torch.utils.flop_counter.FlopCounterMode`) of the program's plain
route at the `smoke` preset on the CPU. The two differ by exactly the work
the benchmark leaves out on purpose, each named here by operation: the
upsample conv's phase form over the (H+1)·(W+1) padded plane instead of
H·W, and K2's plain version recomputing the gates in the backward."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import data, flops
from port_bench.reference import model as ref
from port_bench.tests.smoke import SMOKE_FLAGS

SEED = 7


def _program():
    from dvdgan_tpu_torch.utils.config import Config
    import dataclasses
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in SMOKE_FLAGS.items() if k in known})
    return cfg


def _extras(s: flops.Shape, b: int, train: bool) -> dict[str, float]:
    """The program's work that the model count leaves out, by operation."""
    t = s.n_frames
    phase = recompute = 0.0
    for i, (r, _, cin) in enumerate(s.gru_levels()):
        cout = s.g_width(i + 1)
        per = 2 * 16 * (2 * r + 1) * cin * cout * t     # one clip's border
        if train:
            # fake pass and G update forward, then dX and dW of the G update
            phase += per * (s.d_steps * b + b) + 2 * per * b
            recompute += 2 * 9 * t * b * r * r * cin * 3 * cin
        else:
            phase += per * b
    return {"upsample phase conv border (aten.convolution[_backward])": phase,
            "K2 plain gate recompute (aten.convolution)": recompute}


def _table(counted: dict) -> str:
    return ", ".join(f"{k}: {v:.6g}" for k, v in counted.items())


def test_train_step_flops_match_the_flop_counter():
    from dvdgan_tpu_torch.train import step as step_mod
    cfg = _program()
    f = dict(SMOKE_FLAGS)
    spec, shape = ref.spec_from_flags(f), flops.Shape.of(f)
    b = f["batch_size"]
    st = data.to_program(data.make_state(spec, SEED, "cpu"))
    clips = data.ClipSet(64, f["n_frames"], f["img_size"], f["n_classes"],
                         SEED)
    real, y = data.batch(clips, data.batch_items(64, b, SEED, 0))
    g, ds, dt, tc = (cfg.g_config(), cfg.ds_config(), cfg.dt_config(),
                     cfg.train_config())
    draws = step_mod.TorchDraws(SEED, 0, b, g.z_dim, g.n_frames, ds.k_frames,
                                torch.float32, "cpu")
    with FlopCounterMode(display=False) as fc:
        step_mod.train_step(st, torch.from_numpy(real), torch.from_numpy(y),
                            draws, g, ds, dt, tc)
    counted = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    model = flops.train_step_flops(shape, b)
    extras = _extras(shape, b, train=True)
    expected = sum(model.values()) + sum(extras.values())
    assert fc.get_total_flops() == expected, (
        f"FlopCounterMode by op: {_table(counted)}; benchmark by phase: "
        f"{_table(model)}; named extras: {_table(extras)}")


def test_sample_flops_match_the_flop_counter():
    from dvdgan_tpu_torch.train import step as step_mod
    cfg = _program()
    f = dict(SMOKE_FLAGS)
    spec, shape = ref.spec_from_flags(f), flops.Shape.of(f)
    b = 4
    st = data.to_program(data.make_state(spec, SEED, "cpu", models=("g",)))
    z, y = data.sample_inputs(SEED, 0, b, spec.z_dim, spec.n_classes,
                              torch.float32, "cpu")
    with FlopCounterMode(display=False) as fc:
        step_mod.sample(st["g_ema"], st["g"]["stats"], st["g"]["sn_u"], z, y,
                        cfg.g_config())
    counted = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    extras = _extras(shape, b, train=False)
    expected = flops.sample_flops(shape, b) + sum(extras.values())
    assert fc.get_total_flops() == expected, (
        f"FlopCounterMode by op: {_table(counted)}; benchmark: "
        f"{flops.sample_flops(shape, b):.6g}; named extras: "
        f"{_table(extras)}")


def test_bounds_are_the_frozen_yardstick():
    # K1 at the flagship's 32²×64 level, T 16, B 16, bf16: operations bound
    assert flops.fwd_flops(16, 16, 32, 32, 64) == 2 * 9 * 16 * 16 * 1024 * \
        64 * 192
    ms = flops.fwd_bound(16, 16, 32, 32, 64, "bf16")
    assert abs(ms - flops.fwd_flops(16, 16, 32, 32, 64) / 989e12 * 1e3) \
        < 1e-12
    # K2's launches do two thirds of K2's work with the dW
    assert flops.k2_kernel_flops(2, 3, 4, 5, 6) * 3 == \
        flops.bwd_flops(2, 3, 4, 5, 6) * 2
