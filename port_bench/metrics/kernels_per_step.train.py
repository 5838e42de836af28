"""The kernel nodes a train step of the K-step CUDA graph, less its span
markers: the program's own count at the graph's capture
(`MultiStep.kernel_nodes`, kept process-wide in
`dvdgan_tpu_torch.utils.profiling.COUNTERS`, which holds the count of the
graph captured last: in a training cell, the cell's own). None where the
program keeps no such count."""

LAYER = "train step"
UNIT = "launches"
SOURCE = "program_counter"
MOVES = "train_clips_per_s"
BETTER = "lower"


def read(r):
    from dvdgan_tpu_torch.utils import profiling
    counters = getattr(profiling, "COUNTERS", None)
    return getattr(counters, "kernel_nodes", None)
