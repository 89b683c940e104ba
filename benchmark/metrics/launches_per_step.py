"""Kernel launches per step over the traced steps."""

from benchmark import readers

LAYER = "step orchestration (ns/ns.py, ns/cnlinear.py)"
SOURCE = "device_trace"
UNIT = "launches/step"
MOVES = "steps_per_s"

read = readers.launches_per_step
