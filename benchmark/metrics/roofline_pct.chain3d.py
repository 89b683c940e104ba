"""The chain3d stages' share of their memory roofline (pass C)."""

from benchmark import spans

LAYER = "stencil kernels (ops/cuda_stencil.py, csrc/)"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "steps_per_s"

read = spans.roofline_pct_chain3d
