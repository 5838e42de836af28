"""Device ms a train step of every kernel that is neither the port's own,
nor cuDNN's or cuBLAS's convolutions and GEMMs, nor NCCL's: PyTorch's
elementwise, reduction, copy and layout kernels (the profiler's kernels by
name, `trace.family`)."""

LAYER = "kernels"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_clips_per_s"
BETTER = "lower"


def read(r):
    ms = r.timeline.family_s("elementwise") * 1e3 / r.units_traced
    return ms if ms > 0 else None
