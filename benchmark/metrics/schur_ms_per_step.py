"""Device ms per step of the kernels under the Schur solve and its multigrid (pass C)."""

from benchmark import spans

LAYER = "Schur solve and multigrid (ns/cnlinear.py, solvers/mg.py)"
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "steps_per_s"

read = spans.schur_ms_per_step
