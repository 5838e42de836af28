"""`dvdgan_tpu_torch/utils/profiling.py` against the contract of
`tests/test_profiling.py` (the reference's cases of what the port keeps:
the NaN check, a named range in a trace, the trace files), plus the two
that a PyTorch port adds: `nan_check_mode` also catches a NaN made in a
backward, and it restores autograd's anomaly mode and leaves no dispatch
mode behind. The spans and counters: `test_torch_port_spans.py`."""

import glob
import json

import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from dvdgan_tpu_torch.utils import profiling


def test_nan_check_mode_catches_nan():
    # 0 / 0 is the first NaN; the op that made it is named
    with pytest.raises(FloatingPointError, match="aten.div"):
        with profiling.nan_check_mode():
            torch.zeros(()) / 0.0 * 0.0
    # and the flags are restored afterwards
    assert not torch.is_anomaly_enabled()
    assert _get_current_dispatch_mode() is None


def test_scope_is_usable(tmp_path):
    profiling.enable(True)
    try:
        with profiling.trace(str(tmp_path)):
            with profiling.span("block"):
                y = torch.ones(2) + 1
    finally:
        profiling.enable(False)
    assert y.shape == (2,)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "dvdgan.block" in names


def test_trace_writes_files(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        torch.ones(8) + 1
    assert glob.glob(d + "/**/*.pt.trace.json", recursive=True)


class _NaNGrad(torch.autograd.Function):
    """Identity forward; a backward that makes NaN from finite inputs."""

    @staticmethod
    def forward(ctx, x):
        return x * 1.0

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_nan_check_mode_catches_a_nan_made_in_a_backward():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="aten.mul"):
        with profiling.nan_check_mode():
            loss = _NaNGrad.apply(x).sum()       # finite forward
            assert torch.isfinite(loss)
            loss.backward()
    assert not torch.is_anomaly_enabled()
    assert _get_current_dispatch_mode() is None


def test_nan_check_mode_keeps_an_outer_anomaly_mode_and_passes_finite_work():
    with profiling.anomaly_mode(True):
        with profiling.nan_check_mode():
            x = torch.ones(3, requires_grad=True)
            (torch.empty(3).fill_(1.0) * x).sum().backward()
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
    assert torch.equal(x.grad, torch.ones(3))
