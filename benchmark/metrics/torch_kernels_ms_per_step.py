"""Device ms per step of the kernels not built from csrc/."""

from benchmark import readers

LAYER = "solvers and operators in torch ops (solvers/, ns/operators.py, ibm/)"
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "steps_per_s"

read = readers.torch_kernels_ms_per_step
