"""Host ms per step of the step's own enqueueing, its spans less the host reads (pass B)."""

from benchmark import spans

LAYER = "host launch path (ns/, solvers/, ops/cuda_stencil.py)"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "steps_per_s"

read = spans.host_busy_ms_per_step
