"""K1's and K3's share of their roofline a sampler batch
(`readers.gru_roofline_pct`)."""

from port_bench import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "sample_clips_per_s"
BETTER = "higher"

read = readers.gru_roofline_pct
