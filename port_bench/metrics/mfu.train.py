"""The train step's share of the cards' bf16 peak: the model's FLOPs a step
(`flops.train_step_flops`) over the untraced window's time a step
(`readers.mfu_pct`)."""

from port_bench import readers

LAYER = "train step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_clips_per_s"
BETTER = "higher"

read = readers.mfu_pct
