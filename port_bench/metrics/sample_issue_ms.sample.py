"""Host ms a sampler batch spent inside the program's `step.sample`, from
its call to its return: the host's issue of SN and G's levels, which the
card's work overlaps. Over every batch of the run but the process's
first (which builds the kernels and picks cuDNN's plans, and which the
program counts apart): the rest of the warm-up batches, the untraced
window's and the traced window's, whose issue the profiler slows. Read
from the program's counters (`dvdgan_tpu_torch.utils.profiling.COUNTERS`);
None where the program keeps none."""

LAYER = "sampler"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "sample_clips_per_s"
BETTER = "lower"


def read(r):
    from dvdgan_tpu_torch.utils import profiling
    c = getattr(profiling, "COUNTERS", None)
    calls = getattr(c, "sample_calls", 0)
    return c.sample_issue_s * 1e3 / calls if calls else None
