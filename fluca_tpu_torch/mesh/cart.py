"""Cartesian staggered grid.

Counterpart of fluca_tpu.mesh.cart (reference MESHCART,
fluca/src/mesh/impl/cart/cart.c). A mesh is a light host-side object
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

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from fluca_tpu_torch.utils import config


class BoundaryLoc(enum.IntEnum):
    """Boundary index mapping (reference: MeshCartGetBoundaryIndex,
    fluca/src/mesh/impl/cart/cart.c:564-591)."""

    LEFT = 0
    RIGHT = 1
    DOWN = 2
    UP = 3
    BACK = 4
    FRONT = 5

    @property
    def axis(self) -> int:
        return int(self) // 2

    @property
    def is_low(self) -> bool:
        return int(self) % 2 == 0


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

    @classmethod
    def from_options(cls, opts, prefix: str = "cart_") -> "CartMesh":
        """Reference: MeshSetFromOptions_Cart (cart.c:13-54)."""
        o = opts.sub(prefix)
        dim = o.get_int("dim", 2)
        names = ["x", "y", "z"][:dim]
        N = tuple(o.get_int(f"grid_{c}", 8) for c in names)
        periodic = tuple(
            o.get_str(f"boundary_type_{c}", "none").lower() == "periodic"
            for c in names
        )
        refine = o.get_int("refine", 0)
        mesh = cls.create(N, periodic, refine)
        lo = tuple(o.get_real(f"{c}min", 0.0) for c in names)
        hi = tuple(o.get_real(f"{c}max", 1.0) for c in names)
        mesh.set_uniform_coordinates(*[b for ab in zip(lo, hi) for b in ab])
        return mesh

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

    def face_coords(self, d: int) -> np.ndarray:
        """Coordinates of owned faces (length nfaces(d))."""
        f = self.faces[d]
        return f[: self.N[d]] if self.periodic[d] else f

    def length(self, d: int) -> float:
        return float(self.faces[d][-1] - self.faces[d][0])

    # -- field allocation helpers -------------------------------------
    # Every call makes new tensors: state leaves never share storage.
    def zeros_cell(self, device, dtype=None):
        return torch.zeros(
            self.cell_shape, dtype=config.resolve_dtype(dtype),
            device=device,
        )

    def zeros_cell_vector(self, device, dtype=None):
        return tuple(self.zeros_cell(device, dtype) for _ in range(self.dim))

    def zeros_face(self, device, dtype=None):
        dt = config.resolve_dtype(dtype)
        return tuple(
            torch.zeros(self.face_shape(d), dtype=dt, device=device)
            for d in range(self.dim)
        )

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
