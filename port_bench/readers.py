"""The arithmetic that per-layer metrics share, one function per kind of
reading; each metric file under `metrics/` names its layer, unit, source
and moved metric and takes its `read` from here or defines its own. Each
returns None where the trace holds nothing to read."""

from __future__ import annotations

from port_bench.common import PEAK_BF16, Readings


def idle_pct(r: Readings):
    """The device's idle share over the traced window of whole units: 1 −
    the union of its kernels, copies and fills (profiler) / the window,
    in %."""
    tl = r.timeline
    if tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def mfu_pct(r: Readings):
    """The model's FLOPs a unit (`flops`, from shapes) over the untraced
    window's seconds a unit, over chips × 989 TFLOP/s (bf16, dense), in
    %."""
    if r.unit_s <= 0:
        return None
    return 100.0 * r.flops_per_unit / r.unit_s / (r.chips * PEAK_BF16)


def gru_roofline_pct(r: Readings):
    """The GRU kernels' least time a unit (`flops.gru_bound_ms`: the larger
    of operations over 989 TFLOP/s and bytes over 3.35 TB/s, at the cell's
    shapes and launches) over their profiler device time a unit, in %."""
    ms = r.timeline.family_s("gru") * 1e3 / r.units_traced
    if ms <= 0:
        return None
    return 100.0 * r.gru_bound_ms / ms
