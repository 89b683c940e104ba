"""The plain reference of the benchmark: one time step of the solver in
plain PyTorch, a frozen copy of the port's plain path (mesh, tables,
banded operators, Krylov solvers, multigrid, the CNLinear step and the
immersed-boundary forcing) on one whole grid. It imports nothing of the
code under test, so a change there cannot move it."""
