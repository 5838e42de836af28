"""K1's, K2's own launches' and K3's share of their roofline a train step
(`readers.gru_roofline_pct`)."""

from port_bench import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_clips_per_s"
BETTER = "higher"

read = readers.gru_roofline_pct
