"""Device-to-host reads per step, the program's counter (pass B)."""

from benchmark import spans

LAYER = "host-device synchronisation (solvers/krylov.py, ns/ns.py)"
SOURCE = "program_counter"
UNIT = "reads/step"
MOVES = "steps_per_s"

read = spans.host_reads_per_step
