"""The device's idle share over the traced window of whole train steps (`readers.idle_pct`)."""

from port_bench import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_clips_per_s"
BETTER = "lower"

read = readers.idle_pct
