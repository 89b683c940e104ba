"""Navier-Stokes boundary conditions.

Reference: fluca/include/flucansbc.h and the per-BC-type switch blocks
throughout fluca/src/ns/impl/linearcn/cnlinearcart{2d,3d}.c. Value
callbacks take torch tensors: ``velocity(t, x)`` receives the time (a
Python float) and a tuple of coordinate tensors broadcast over the
boundary plane, and returns a tuple of ``dim`` tensors;
``pressure(t, x)`` returns one tensor.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional


class BCType(enum.Enum):
    VELOCITY = "velocity"
    PRESSURE_OUTLET = "pressure_outlet"
    PERIODIC = "periodic"
    SYMMETRY = "symmetry"


@dataclass(frozen=True)
class BoundaryCondition:
    type: BCType
    velocity: Optional[Callable] = None  # (t, xs) -> tuple[dim arrays]
    pressure: Optional[Callable] = None  # (t, xs) -> array

    def __post_init__(self):
        if self.type == BCType.VELOCITY and self.velocity is None:
            raise ValueError("VELOCITY boundary requires a velocity callback")
        if self.type == BCType.PRESSURE_OUTLET and self.pressure is None:
            raise ValueError(
                "PRESSURE_OUTLET boundary requires a pressure callback"
            )


def zero_velocity_bc() -> BoundaryCondition:
    return BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: tuple(0.0 * x for x in xs),
    )


def validate_bcs(mesh, bcs) -> None:
    """Check bc/mesh consistency: periodic mesh axes must carry
    PERIODIC bcs on both sides and vice versa (reference: implicit in
    MeshCart boundary types vs NS bc table)."""
    assert len(bcs) == 2 * mesh.dim, "need one bc per boundary (2*dim)"
    for d in range(mesh.dim):
        lo, hi = bcs[2 * d], bcs[2 * d + 1]
        if mesh.periodic[d]:
            assert lo.type == hi.type == BCType.PERIODIC, (
                f"axis {d} is periodic; both bcs must be PERIODIC"
            )
        else:
            assert BCType.PERIODIC not in (lo.type, hi.type), (
                f"axis {d} is not periodic; PERIODIC bc invalid"
            )
