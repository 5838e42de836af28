"""The device's idle share over the traced window of whole sampler batches (`readers.idle_pct`)."""

from port_bench import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "sample_clips_per_s"
BETTER = "lower"

read = readers.idle_pct
