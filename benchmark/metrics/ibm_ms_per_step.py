"""Device ms per step of the kernels under the IBM forcing (pass C)."""

from benchmark import spans

LAYER = "IBM forcing (ibm/)"
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "steps_per_s.wake"

read = spans.ibm_ms_per_step
