"""The flows the benchmark's configurations run, one module per flow
kind, ``flows/<flow>.py``, found by the ``flow`` key of a configuration
file. Each defines:

- ``build_program(cfg, solver, device)`` -> (the port's NS object, any
  object it needs kept alive);
- ``initial_fields(cfg, seed, device)`` -> the state at t = 0, drawn
  from the seed on the device;
- ``reference_setup(cfg, dtype, device)`` -> (mesh, bcs, rho, mu,
  body_force) of the plain reference, built from ``benchmark.reference``
  alone.
"""
