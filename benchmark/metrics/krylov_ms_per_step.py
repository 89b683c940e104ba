"""Device ms per step of the outer Krylov solver's own kernels (pass C)."""

from benchmark import spans

LAYER = "Krylov outer solve (solvers/krylov.py)"
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "steps_per_s"

read = spans.krylov_ms_per_step
