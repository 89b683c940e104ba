"""Cartesian staggered grid of the plain reference (a frozen copy of the
port's ``mesh/cart.py``, trimmed to what one step needs). A mesh is a light host-side object
holding per-axis coordinate arrays (numpy float64); fields are dense
torch tensors on the device the caller names.

Field layouts (2-D; 3-D analogous; reference meshimpl.h:33-38):
  cell scalar   p      : (Nx, Ny)
  cell vector   v      : tuple of dim tensors, each (Nx, Ny)
  face scalar   U      : tuple per axis: (NFx, Ny), (Nx, NFy)
  face vector   vface  : nested tuple [face-axis][component]

``NF_d = N_d + 1`` for non-periodic axes and ``N_d`` for periodic axes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CartMesh:
    """Cartesian grid: sizes, periodicity, per-axis coordinates.

    Coordinates are stored as per-axis face (vertex) arrays ``faces[d]``
    of length ``N_d + 1`` (for periodic axes ``faces[d][N] =
    faces[d][0] + L`` closes the circle); cell centers are midpoints.
    """

    N: tuple[int, ...]
    periodic: tuple[bool, ...]
    faces: list[np.ndarray] = field(default_factory=list)

    # -- constructors -------------------------------------------------
    @classmethod
    def create(cls, N, periodic=None, refine: int = 0) -> "CartMesh":
        """Reference: MeshCartCreate2d/3d (cart.c:290-314) +
        -cart_refine (cart.c:36-44)."""
        N = tuple(int(n) << refine for n in N)
        if periodic is None:
            periodic = (False,) * len(N)
        periodic = tuple(bool(b) for b in periodic)
        if len(N) != len(periodic) or len(N) not in (1, 2, 3):
            raise ValueError(f"bad mesh sizes {N} / periodicity {periodic}")
        return cls(N=N, periodic=periodic)

    # -- basic queries ------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.N)

    def nfaces(self, d: int) -> int:
        """Number of owned unique faces along axis d."""
        return self.N[d] if self.periodic[d] else self.N[d] + 1

    @property
    def cell_shape(self) -> tuple[int, ...]:
        return self.N

    def face_shape(self, d: int) -> tuple[int, ...]:
        return tuple(
            self.nfaces(a) if a == d else self.N[a] for a in range(self.dim)
        )

    # -- coordinates --------------------------------------------------
    def set_uniform_coordinates(self, *bounds) -> None:
        """Reference: MeshCartSetUniformCoordinates. ``bounds`` is
        (xmin, xmax[, ymin, ymax[, zmin, zmax]])."""
        if len(bounds) < 2 * self.dim:
            raise ValueError(f"need {2 * self.dim} bounds, got {len(bounds)}")
        self.faces = []
        for d in range(self.dim):
            lo, hi = float(bounds[2 * d]), float(bounds[2 * d + 1])
            self.faces.append(np.linspace(lo, hi, self.N[d] + 1))

    def set_coordinates(self, *face_arrays) -> None:
        """Non-uniform grid from explicit per-axis face coordinates."""
        if len(face_arrays) != self.dim:
            raise ValueError(f"need {self.dim} face arrays")
        self.faces = []
        for d, f in enumerate(face_arrays):
            f = np.asarray(f, dtype=np.float64)
            if f.shape != (self.N[d] + 1,):
                raise ValueError(
                    f"axis {d}: need {self.N[d] + 1} face coordinates"
                )
            if not np.all(np.diff(f) > 0):
                raise ValueError(f"axis {d}: faces must increase")
            self.faces.append(f)

    def centers(self, d: int) -> np.ndarray:
        f = self.faces[d]
        return 0.5 * (f[:-1] + f[1:])

    def widths(self, d: int) -> np.ndarray:
        """Cell widths h_i = f[i+1] - f[i]."""
        return np.diff(self.faces[d])

    def length(self, d: int) -> float:
        return float(self.faces[d][-1] - self.faces[d][0])

    # -- misc ----------------------------------------------------------
    def cell_volumes(self) -> np.ndarray:
        """Dense array of cell volumes (outer product of widths)."""
        vol = self.widths(0)
        for d in range(1, self.dim):
            vol = np.multiply.outer(vol, self.widths(d))
        return vol

    def __repr__(self):
        per = ",".join("P" if p else "N" for p in self.periodic)
        return f"CartMesh(N={self.N}, periodic=({per}))"


def stretched_faces(n, delta, g):
    """tanh wall clustering of ``n`` cells over [0, 2 delta]:
    y_j = delta (1 + tanh(g (2j/n - 1)) / tanh(g))."""
    xi = np.linspace(-1.0, 1.0, n + 1)
    if abs(g) < 1e-12:
        return delta * (1.0 + xi)
    return delta * (1.0 + np.tanh(g * xi) / np.tanh(g))
