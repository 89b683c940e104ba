"""The 3-D Poisson stencil's share of its memory roofline."""

from benchmark import readers

LAYER = "stencil kernels (ops/cuda_stencil.py, csrc/)"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "steps_per_s"

read = readers.roofline_pct_poisson3d
