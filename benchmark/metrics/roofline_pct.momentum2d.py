"""The 2-D momentum A-apply's share of its memory roofline: the launch counter's
launches (pass B) over the kernel's device time (pass A)."""

from benchmark import roofline_2d

LAYER = "stencil kernels (ops/cuda_stencil.py, csrc/)"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "steps_per_s"

read = roofline_2d.roofline_pct_momentum2d
