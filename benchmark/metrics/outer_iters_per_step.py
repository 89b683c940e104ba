"""Outer FGMRES iterations per step over the window."""

from benchmark import readers

LAYER = "Krylov outer solve (solvers/krylov.py)"
SOURCE = "program_counter"
UNIT = "iters/step"
MOVES = "steps_per_s.rtol"

read = readers.outer_iters_per_step
