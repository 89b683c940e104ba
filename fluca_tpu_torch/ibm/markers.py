"""Lagrangian marker sets and their interpolation and spreading
operators (counterpart of fluca_tpu.ibm.markers).

Each marker owns a (support x support [x support]) window of cells.
Interpolation is a gather and a weighted sum over each window. Spreading
is its transpose, a sum into the cells; the reference computes both
with XLA's gather and scatter-add, outside any Pallas kernel, so plain
torch operations are their counterpart here.

The spread must give the same bits on every run, and a scatter-add
(``index_add_``, ``index_put_(accumulate=True)``) on a CUDA tensor adds
with atomics in no fixed order. So the spread is a gather and a
segmented sum in a fixed order: the (marker, tap) pairs are sorted once
by target cell (a stable sort, so each cell's contributions keep marker
order), laid out as a padded (touched cells x most contributions per
cell) index table, gathered, summed along each row and written to the
cells, each once. Its sums are taken in another order than XLA's
scatter, so the two agree to rounding, not bit for bit.

For a stationary body (``X`` not given to a call) the windows, weights
and spread table are computed once per MarkerSet, on its device and in
its dtype: the same bits as computing them per call, without the
launches. A call with explicit positions ``X`` computes them anew and
reads the largest cell count back to the host.

Requires uniform grid spacing around the body (the delta kernels assume
it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from fluca_tpu_torch.ibm.delta import KERNELS
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.utils import config, profiling


@dataclass
class _Plan:
    """The windows of one set of marker positions: flat cell index and
    tensor-product weight of every (marker, tap) pair, (Nm, S^dim); and
    the spread's table: the touched cells (U,), and for each the
    positions of its pairs in the flattened (Nm * S^dim) order, padded
    with Nm * S^dim (a zero slot), (U, most pairs per cell)."""

    lin: torch.Tensor
    weights: torch.Tensor
    cells: torch.Tensor
    table: torch.Tensor


@dataclass
class MarkerSet:
    mesh: CartMesh
    X: torch.Tensor  # (Nm, dim) marker positions
    ds: torch.Tensor  # (Nm,) arc length / area weight per marker
    kernel: str = "roma3"

    def __post_init__(self):
        mesh = self.mesh
        dim = mesh.dim
        for d in range(dim):
            w = mesh.widths(d)
            if not np.allclose(w, w[0]):
                raise ValueError("IBM requires uniform grid spacing (per axis)")
        self.h = np.array([float(mesh.widths(d)[0]) for d in range(dim)])
        self.x0 = np.array([float(mesh.centers(d)[0]) for d in range(dim)])
        self.fn, self.support = KERNELS[self.kernel]
        self.offsets = np.arange(self.support) - (self.support - 1) // 2
        self._static = None

    # -- windows -------------------------------------------------------
    def _windows(self, X):
        """Cell indices (Nm, support, dim), int64, and weights
        (Nm, support, dim) per axis, in X's dtype."""
        mesh = self.mesh
        h = torch.as_tensor(self.h, dtype=X.dtype, device=X.device)
        x0 = torch.as_tensor(self.x0, dtype=X.dtype, device=X.device)
        # nearest cell index per axis; torch.round, like jnp.round,
        # rounds half to even
        base = torch.round((X - x0) / h).to(torch.int64)  # (Nm, dim)
        offs = torch.as_tensor(self.offsets, dtype=torch.int64, device=X.device)
        idx = base[:, None, :] + offs[None, :, None]  # (Nm, S, dim)
        xc = x0 + idx.to(X.dtype) * h  # cell-center coordinates
        r = (X[:, None, :] - xc) / h
        w = self.fn(r)  # (Nm, S, dim)
        cols = []
        for d in range(mesh.dim):
            n = mesh.N[d]
            i = idx[:, :, d]
            cols.append(torch.remainder(i, n) if mesh.periodic[d]
                        else torch.clamp(i, 0, n - 1))
        return torch.stack(cols, dim=2), w

    def _plan(self, X) -> _Plan:
        idx, w = self._windows(X)
        dim = self.mesh.dim
        N = self.mesh.N
        nm, s = idx.shape[:2]
        if dim == 2:
            lin = idx[:, :, 0][:, :, None] * N[1] + idx[:, :, 1][:, None, :]
            ww = w[:, :, 0][:, :, None] * w[:, :, 1][:, None, :]
        else:
            lin = ((idx[:, :, 0][:, :, None, None] * N[1]
                    + idx[:, :, 1][:, None, :, None]) * N[2]
                   + idx[:, :, 2][:, None, None, :])
            ww = (w[:, :, 0][:, :, None, None] * w[:, :, 1][:, None, :, None]
                  * w[:, :, 2][:, None, None, :])
        lin = lin.reshape(nm, s ** dim)
        ww = ww.reshape(nm, s ** dim)
        flat = lin.reshape(-1)
        order = torch.argsort(flat, stable=True)
        cells, counts = torch.unique_consecutive(flat[order], return_counts=True)
        most = profiling.read(counts.max(), "ibm.plan", int)
        starts = torch.cumsum(counts, 0) - counts
        j = torch.arange(most, device=X.device)
        pos = torch.clamp(starts[:, None] + j[None, :], max=flat.numel() - 1)
        table = torch.where(j[None, :] < counts[:, None], order[pos],
                            torch.full_like(pos, flat.numel()))
        return _Plan(lin=lin, weights=ww, cells=cells, table=table)

    def plan(self, X=None) -> _Plan:
        """The windows of ``X``; of the markers' own positions (computed
        once) when X is None."""
        if X is not None:
            return self._plan(X)
        if self._static is None:
            self._static = self._plan(self.X)
        return self._static

    # -- operators -----------------------------------------------------
    def interpolate(self, field, X=None):
        """E: cell field -> marker values (gather)."""
        pl = self.plan(X)
        vals = field.reshape(-1)[pl.lin]  # (Nm, S^dim)
        return torch.sum(vals * pl.weights, dim=1)

    def spread(self, F, X=None):
        """S: marker values (Nm,) -> cell field, scaled by ds / cell
        volume so that S and E are adjoint up to the marker quadrature
        weights. Deterministic: see the module docstring."""
        pl = self.plan(X)
        cellvol = float(np.prod(self.h))
        scale = (self.ds / cellvol) * F  # (Nm,)
        vals = (scale[:, None] * pl.weights).reshape(-1)
        vals = torch.cat([vals, vals.new_zeros(1)])  # the padding slot
        sums = vals[pl.table].sum(dim=1)
        out = F.new_zeros(math.prod(self.mesh.cell_shape))
        out.index_copy_(0, pl.cells, sums)
        return out.view(self.mesh.cell_shape)


def _marker_tensors(X, ds, device, dtype):
    dt = config.resolve_dtype(dtype)
    return (torch.tensor(X, dtype=dt, device=device),
            torch.tensor(ds, dtype=dt, device=device))


def _check_retract(retract, h, radius):
    if not 0.0 <= retract * h < radius:
        raise ValueError(
            f"retract={retract} with h={h} yields marker radius "
            f"{radius - retract * h} (nominal {radius}); require "
            f"0 <= retract*h < radius"
        )


def sphere_markers(
    mesh: CartMesh, center, radius, n_markers=None, kernel="roma3",
    dtype=None, retract=0.0, *, device,
) -> MarkerSet:
    """Quasi-uniform markers on a sphere via the Fibonacci lattice,
    spaced ~ grid h, each owning surface area ~ (4 pi r^2 / Nm) * h
    (volumetric thickness ~h, as for circle_markers).

    ``retract`` (in cell widths): place markers at radius - retract*h.
    The regularized delta smears the no-slip surface outward by ~0.5h,
    so the effective hydrodynamic radius exceeds the marker radius and
    drag is over-predicted at moderate cells/diameter; inward retraction
    by 0.3-0.5h cancels the widening (Breugem, J. Comput. Phys. 231
    (2012) 4469-4498, Sec. 3). Marker count and quadrature weights stay
    tied to the nominal radius."""
    h = float(mesh.widths(0)[0])
    if n_markers is None:
        n_markers = max(int(np.ceil(4 * np.pi * radius**2 / h**2)), 16)
    _check_retract(retract, h, radius)
    r_mark = radius - retract * h
    i = np.arange(n_markers) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n_markers)
    golden = np.pi * (1.0 + 5.0**0.5)
    theta = golden * i
    X = np.stack(
        [
            center[0] + r_mark * np.sin(phi) * np.cos(theta),
            center[1] + r_mark * np.sin(phi) * np.sin(theta),
            center[2] + r_mark * np.cos(phi),
        ],
        axis=1,
    )
    ds = np.full(n_markers, 4 * np.pi * radius**2 / n_markers * h)
    return MarkerSet(mesh, *_marker_tensors(X, ds, device, dtype), kernel)


def circle_markers(
    mesh: CartMesh, center, radius, n_markers=None, kernel="roma3",
    dtype=None, retract=0.0, *, device,
) -> MarkerSet:
    """Markers on a circle with spacing ~ grid h (the standard ds ~= h
    rule). ``retract``: see sphere_markers."""
    h = float(mesh.widths(0)[0])
    if n_markers is None:
        n_markers = max(int(np.ceil(2 * np.pi * radius / h)), 8)
    th = np.linspace(0.0, 2 * np.pi, n_markers, endpoint=False)
    _check_retract(retract, h, radius)
    r_mark = radius - retract * h
    X = np.stack(
        [center[0] + r_mark * np.cos(th), center[1] + r_mark * np.sin(th)],
        axis=1,
    )
    # ds includes the surface-normal thickness ~h so the spread force
    # has units of a volumetric body force
    ds = np.full(n_markers, 2 * np.pi * radius / n_markers * h)
    return MarkerSet(mesh, *_marker_tensors(X, ds, device, dtype), kernel)
