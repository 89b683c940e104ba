"""fluca_tpu_torch — the incompressible-flow CFD framework on PyTorch
and CUDA.

The counterpart of ``fluca_tpu`` (the JAX/Pallas package beside it,
which stays the reference), module for module:

- ``fluca_tpu_torch.mesh``    — Cartesian staggered grids.
- ``fluca_tpu_torch.ops``     — banded stencil algebra and the
  hand-written CUDA kernels (``ops/cuda_stencil.py``, ``csrc/``).
- ``fluca_tpu_torch.ns``      — the linearized Crank-Nicolson NS step
  with the ABF preconditioner.
- ``fluca_tpu_torch.solvers`` — Krylov methods and geometric
  multigrid.
- ``fluca_tpu_torch.parallel`` — the domain-decomposed step: device
  grids, the neighbour exchange and the sharded kernels.

Host tables are built in float64 numpy exactly as the reference builds
them, then moved to the device in the compute dtype. Every tensor is
created on the device the caller names.
"""

__version__ = "0.1.0"

from fluca_tpu_torch.utils.options import Options, set_global_options, global_options
from fluca_tpu_torch.utils import config
from fluca_tpu_torch.mesh.cart import CartMesh, BoundaryLoc

_initialized = False


def initialize(argv=None):
    """Initialize the library (reference: FlucaInitialize,
    fluca/src/sys/flucainit.c:7-26). An explicit ``argv`` always
    refreshes the global options database."""
    global _initialized
    if argv is not None:
        set_global_options(Options.from_argv(argv))
    _initialized = True


def finalize():
    """Reference: FlucaFinalize (fluca/src/sys/flucainit.c:44-71)."""
    global _initialized
    _initialized = False
