"""The card's idle share of the traced steps."""

from benchmark import readers

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "steps_per_s"

read = readers.device_idle_pct
