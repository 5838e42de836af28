"""The sampler's share of the card's bf16 peak: G's forward FLOPs a batch
(`flops.sample_flops`) over the untraced window's time a batch
(`readers.mfu_pct`)."""

from port_bench import readers

LAYER = "sampler"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "sample_clips_per_s"
BETTER = "higher"

read = readers.mfu_pct
