"""Per-axis stencil coefficient tables for the CNLinear NS scheme.

Host-side equivalent of the reference's closed-form non-uniform-grid
FD coefficient library (fluca/src/ns/utils/cartdiscret.c) combined with
the per-boundary-condition assembly switches of
fluca/src/ns/impl/linearcn/cnlinearcart2d.c (2-D) / cnlinearcart3d.c
(3-D). Instead of inserting rows into assembled PETSc matrices, each
table function returns banded per-axis coefficient tables (AxisStencil) with
boundary-modified rows baked in, plus scalar boundary-value
coefficients that the NS module turns into RHS "bc vectors".

Every formula below is the closed-form coefficient the reference
computes; citations are given per function. All tables are built on host
in float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mesh import CartMesh
from .bc import BCType
from .banded import AxisStencil


@dataclass(frozen=True)
class AxisBC:
    lo: BCType
    hi: BCType


def axis_bcs(mesh: CartMesh, bcs) -> list[AxisBC]:
    return [
        AxisBC(bcs[2 * d].type, bcs[2 * d + 1].type) for d in range(mesh.dim)
    ]


def _axis_coords(mesh: CartMesh, d: int):
    """centers c[0..N-1], faces f[0..N], periodic ghost centers."""
    c = mesh.centers(d)
    f = mesh.faces[d]
    L = mesh.length(d)
    cW = c[-1] - L  # ghost center left of cell 0 (periodic)
    cE = c[0] + L  # ghost center right of cell N-1 (periodic)
    return c, f, cW, cE


# ----------------------------------------------------------------------
# Cell-centered pressure gradient G (one axis), unscaled (the dt/rho
# factor is applied by the NS module, reference cnlinearcart2d.c:2016).
# Reference: ComputePressureGradientOperator_Private
# (cnlinearcart2d.c:4-153) using cartdiscret.c:3-137 closed forms.
# ----------------------------------------------------------------------


def grad_cell_tables(mesh: CartMesh, d: int, bc: AxisBC):
    """Returns (AxisStencil cell->cell, bc_lo_coef, bc_hi_coef).

    bc coefs multiply the boundary pressure value pb for
    PRESSURE_OUTLET ends (reference
    ComputePressureGradientBoundaryConditionVector_Private,
    cnlinearcart2d.c:155-290); zero otherwise. The NS module adds
    (dt/rho)*coef*pb(t) to the momentum RHS.
    """
    N = mesh.N[d]
    c, f, cWg, cEg = _axis_coords(mesh, d)
    bands = {off: np.zeros(N) for off in (-1, 0, 1, 2, -2)}
    bc_lo = 0.0
    bc_hi = 0.0

    # interior rows: central difference (cartdiscret.c:64-77)
    for i in range(1, N - 1):
        h = c[i + 1] - c[i - 1]
        bands[-1][i] = -1.0 / h
        bands[1][i] = 1.0 / h

    if bc.lo == BCType.PERIODIC:
        h = c[1] - cWg
        bands[-1][0] = -1.0 / h
        bands[1][0] = 1.0 / h
        h = cEg - c[N - 2]
        bands[-1][N - 1] = -1.0 / h
        bands[1][N - 1] = 1.0 / h
        st = AxisStencil.from_dict(d, N, True, bands)
        return st, bc_lo, bc_hi

    # low end (i = 0)
    if bc.lo == BCType.VELOCITY:
        # no pressure condition: one-sided 3-pt (cartdiscret.c:3-24)
        h1, h2 = c[1] - c[0], c[2] - c[0]
        bands[0][0] = -(h1 + h2) / (h1 * h2)
        bands[1][0] = -h2 / (h1 * (h1 - h2))
        bands[2][0] = h1 / (h2 * (h1 - h2))
    elif bc.lo == BCType.PRESSURE_OUTLET:
        # Dirichlet pressure at wall face (cartdiscret.c:26-43)
        h1, h2 = c[0] - f[0], c[1] - c[0]
        bands[0][0] = (h2 - h1) / (h1 * h2)
        bands[1][0] = h1 / (h2 * (h1 + h2))
        bc_lo = -h2 / (h1 * (h1 + h2))
    elif bc.lo == BCType.SYMMETRY:
        # zero pressure gradient (cartdiscret.c:45-62)
        h1, h2 = c[0] - f[0], c[1] - c[0]
        w = 2.0 * h1 / (h2 * (2.0 * h1 + h2))
        bands[0][0] = -w
        bands[1][0] = w

    # high end (i = N-1)
    if bc.hi == BCType.VELOCITY:
        # one-sided 3-pt backward (cartdiscret.c:79-100)
        h1, h2 = c[N - 1] - c[N - 2], c[N - 1] - c[N - 3]
        bands[-2][N - 1] = -h1 / (h2 * (h1 - h2))
        bands[-1][N - 1] = h2 / (h1 * (h1 - h2))
        bands[0][N - 1] = (h1 + h2) / (h1 * h2)
    elif bc.hi == BCType.PRESSURE_OUTLET:
        # (cartdiscret.c:102-119)
        h1, h2 = f[N] - c[N - 1], c[N - 1] - c[N - 2]
        bands[-1][N - 1] = -h1 / (h2 * (h1 + h2))
        bands[0][N - 1] = (h1 - h2) / (h1 * h2)
        bc_hi = h2 / (h1 * (h1 + h2))
    elif bc.hi == BCType.SYMMETRY:
        # (cartdiscret.c:120-137)
        h1, h2 = f[N] - c[N - 1], c[N - 1] - c[N - 2]
        w = 2.0 * h1 / (h2 * (2.0 * h1 + h2))
        bands[-1][N - 1] = -w
        bands[0][N - 1] = w

    return AxisStencil.from_dict(d, N, False, bands), bc_lo, bc_hi


# ----------------------------------------------------------------------
# Velocity Laplacian L (one axis, one velocity component).
# Reference: ComputeVelocityLaplacianOperator_Private
# (cnlinearcart2d.c:292-448) using cartdiscret.c:139-303 closed forms.
# ----------------------------------------------------------------------


def lap_tables(mesh: CartMesh, d: int, bc: AxisBC, comp: int):
    """Returns (AxisStencil cell->cell, bc_lo_coef, bc_hi_coef).

    bc coefs multiply the prescribed boundary velocity component vb
    for VELOCITY ends (reference
    ComputeVelocityLaplacianBoundaryConditionVector_Private,
    cnlinearcart2d.c:450-599); SYMMETRY normal-component Dirichlet rows
    use vb = 0 so contribute nothing.
    """
    N = mesh.N[d]
    c, f, cWg, cEg = _axis_coords(mesh, d)
    bands = {off: np.zeros(N) for off in (-2, -1, 0, 1, 2)}
    bc_lo = 0.0
    bc_hi = 0.0

    def central(i, xW, xE):
        # (cartdiscret.c:210-232): h1=xP-xW, h2=xE-xP, h3=xe-xw
        h1, h2, h3 = c[i] - xW, xE - c[i], f[i + 1] - f[i]
        bands[-1][i] += 1.0 / (h1 * h3)
        bands[0][i] += -(1.0 / (h1 * h3) + 1.0 / (h2 * h3))
        bands[1][i] += 1.0 / (h2 * h3)

    for i in range(1, N - 1):
        central(i, c[i - 1], c[i + 1])

    if bc.lo == BCType.PERIODIC:
        central(0, cWg, c[1])
        central(N - 1, c[N - 2], cEg)
        return AxisStencil.from_dict(d, N, True, bands), 0.0, 0.0

    lo_dirichlet = bc.lo == BCType.VELOCITY or (
        bc.lo == BCType.SYMMETRY and comp == d
    )
    if lo_dirichlet:
        # Dirichlet value at wall face (cartdiscret.c:167-189)
        h1, h2, h3 = c[0] - f[0], c[1] - c[0], c[2] - c[0]
        bands[0][0] = 2.0 * (h1 - h2 - h3) / (h1 * h2 * h3)
        bands[1][0] = 2.0 * (h1 - h3) / (h2 * (h1 + h2) * (h2 - h3))
        bands[2][0] = 2.0 * (h2 - h1) / (h3 * (h1 + h3) * (h2 - h3))
        if bc.lo == BCType.VELOCITY:
            # (cnlinearcart2d.c:494-498)
            bc_lo = 2.0 * (h2 + h3) / (h1 * (h1 + h2) * (h1 + h3))
    else:
        # zero-gradient wall (cartdiscret.c:191-208)
        h1, h2 = c[1] - c[0], f[1] - f[0]
        bands[0][0] = -1.0 / (h1 * h2)
        bands[1][0] = 1.0 / (h1 * h2)

    hi_dirichlet = bc.hi == BCType.VELOCITY or (
        bc.hi == BCType.SYMMETRY and comp == d
    )
    if hi_dirichlet:
        # (cartdiscret.c:262-284)
        h1 = f[N] - c[N - 1]
        h2 = c[N - 1] - c[N - 2]
        h3 = c[N - 1] - c[N - 3]
        bands[-2][N - 1] = 2.0 * (h2 - h1) / (h3 * (h1 + h3) * (h2 - h3))
        bands[-1][N - 1] = 2.0 * (h1 - h3) / (h2 * (h1 + h2) * (h2 - h3))
        bands[0][N - 1] = 2.0 * (h1 - h2 - h3) / (h1 * h2 * h3)
        if bc.hi == BCType.VELOCITY:
            # (cnlinearcart2d.c:522-526)
            bc_hi = 2.0 * (h2 + h3) / (h1 * (h1 + h2) * (h1 + h3))
    else:
        # (cartdiscret.c:286-303)
        h1, h2 = c[N - 1] - c[N - 2], f[N] - f[N - 1]
        bands[-1][N - 1] = 1.0 / (h1 * h2)
        bands[0][N - 1] = -1.0 / (h1 * h2)

    return AxisStencil.from_dict(d, N, False, bands), bc_lo, bc_hi


# ----------------------------------------------------------------------
# Cell -> face linear interpolation (one axis, one component): the rows
# of the B (face vector) and T (face-normal) operators.
# Reference: ComputeFaceVelocityInterpolationOperator_Private
# (cnlinearcart2d.c:1044-1207) and
# ComputeFaceNormalVelocityInterpolationOperator_Private
# (cnlinearcart2d.c:1331-1474), cartdiscret.c:373-423.
# ----------------------------------------------------------------------


def interp_tables(mesh: CartMesh, d: int, bc: AxisBC, comp: int):
    """Returns (AxisStencil cell->face, lo_insert, hi_insert).

    ``lo_insert``/``hi_insert`` are True when the boundary face value
    is the prescribed velocity component (VELOCITY bc; and SYMMETRY for
    the normal component, which prescribes 0): the face row is zero and
    the NS bc vector inserts vb there (reference
    ComputeFaceVelocityInterpolationBoundaryConditionVector_Private,
    cnlinearcart2d.c:1209-1329).
    """
    N = mesh.N[d]
    nf = mesh.nfaces(d)
    c, f, cWg, _ = _axis_coords(mesh, d)
    bands = {off: np.zeros(nf) for off in (-2, -1, 0, 1)}
    lo_insert = False
    hi_insert = False

    def interior(i, xW):
        # face i between cells i-1, i (cartdiscret.c:373-386)
        xw, xP = f[i], c[i]
        bands[-1][i] = (xP - xw) / (xP - xW)
        bands[0][i] = (xw - xW) / (xP - xW)

    for i in range(1, N):
        interior(i, c[i - 1])

    if bc.lo == BCType.PERIODIC:
        interior(0, cWg)  # face 0 wraps to cell N-1 via offset -1
        return AxisStencil.from_dict(d, nf, True, bands), False, False

    # low face (i = 0)
    if bc.lo == BCType.VELOCITY or (bc.lo == BCType.SYMMETRY and comp == d):
        lo_insert = True  # value prescribed (vb, or 0 for symmetry)
    else:
        # zero-gradient extrapolation (cartdiscret.c:388-405)
        h1, h2 = c[0] - f[0], c[1] - f[0]
        bands[0][0] = -(h2 * h2) / ((h1 + h2) * (h1 - h2))
        bands[1][0] = (h1 * h1) / ((h1 + h2) * (h1 - h2))

    # high face (i = N)
    if bc.hi == BCType.VELOCITY or (bc.hi == BCType.SYMMETRY and comp == d):
        hi_insert = True
    else:
        # (cartdiscret.c:406-423)
        h1, h2 = f[N] - c[N - 1], f[N] - c[N - 2]
        bands[-2][N] = (h1 * h1) / ((h1 + h2) * (h1 - h2))
        bands[-1][N] = -(h2 * h2) / ((h1 + h2) * (h1 - h2))

    return AxisStencil.from_dict(d, nf, False, bands), lo_insert, hi_insert


# ----------------------------------------------------------------------
# Staggered (face-normal) pressure gradient Gst, unscaled.
# Reference: ComputeStaggeredPressureGradientOperator_Private
# (cnlinearcart2d.c:1662-1795), cartdiscret.c:425-477; bc vector
# cnlinearcart2d.c:1797-1931.
# ----------------------------------------------------------------------


def gst_tables(mesh: CartMesh, d: int, bc: AxisBC):
    """Returns (AxisStencil cell->face, bc_lo_coef, bc_hi_coef);
    bc coefs multiply the outlet boundary pressure pb."""
    N = mesh.N[d]
    nf = mesh.nfaces(d)
    c, f, cWg, _ = _axis_coords(mesh, d)
    bands = {off: np.zeros(nf) for off in (-2, -1, 0, 1)}
    bc_lo = 0.0
    bc_hi = 0.0

    def interior(i, xW):
        # (cartdiscret.c:444-457): two-point center difference
        h = c[i] - xW
        bands[-1][i] = -1.0 / h
        bands[0][i] = 1.0 / h

    for i in range(1, N):
        interior(i, c[i - 1])

    if bc.lo == BCType.PERIODIC:
        interior(0, cWg)
        return AxisStencil.from_dict(d, nf, True, bands), 0.0, 0.0

    # low face: VELOCITY/SYMMETRY -> zero pressure gradient (row stays 0)
    if bc.lo == BCType.PRESSURE_OUTLET:
        # (cartdiscret.c:425-442): h1 = c0-f0, h2 = c1-f0
        h1, h2 = c[0] - f[0], c[1] - f[0]
        bands[0][0] = -h2 / (h1 * (h1 - h2))
        bands[1][0] = h1 / (h2 * (h1 - h2))
        # bc vector (cnlinearcart2d.c:1835-1838)
        bc_lo = -(h1 + h2) / (h1 * h2)

    if bc.hi == BCType.PRESSURE_OUTLET:
        # (cartdiscret.c:459-477): h1 = fN-c_{N-1}, h2 = fN-c_{N-2}
        h1, h2 = f[N] - c[N - 1], f[N] - c[N - 2]
        bands[-2][N] = -h1 / (h2 * (h1 - h2))
        bands[-1][N] = h2 / (h1 * (h1 - h2))
        # (cnlinearcart2d.c:1860-1863)
        bc_hi = (h1 + h2) / (h1 * h2)

    return AxisStencil.from_dict(d, nf, False, bands), bc_lo, bc_hi


# ----------------------------------------------------------------------
# Face-normal velocity divergence D (one axis contribution).
# Reference: ComputeStaggeredVelocityDivergenceOperator_Private
# (cnlinearcart2d.c:1589-1660): out[i] = (U[i+1]-U[i])/h_i, no BC
# variants.
# ----------------------------------------------------------------------


def div_tables(mesh: CartMesh, d: int):
    """Returns AxisStencil face->cell."""
    N = mesh.N[d]
    h = mesh.widths(d)
    bands = {0: -1.0 / h, 1: 1.0 / h}
    return AxisStencil.from_dict(d, N, mesh.periodic[d], bands)


# ----------------------------------------------------------------------
# Linearized convection C (one axis contribution to row component c):
#   (C v)_c += d/dx_d ( vface_c * facefactor ) / 2
# decomposed per cell as left-face and right-face flux terms whose
# geometric weights are precomputed; the face factor (V0 or v0interp)
# multiplies at run time. Reference: ComputeConvectionOperator_Private
# (cnlinearcart2d.c:601-897), cartdiscret.c:305-371.
# ----------------------------------------------------------------------


def conv_tables(mesh: CartMesh, d: int, bc: AxisBC, col_is_normal: bool):
    """Geometric weights for the convection flux difference along axis
    ``d`` acting on a cell field.

    ``col_is_normal`` selects boundary behavior at SYMMETRY ends: the
    interpolated quantity is the normal velocity component (always zero
    at a symmetry plane -> term dropped, cnlinearcart2d.c:669-674 with
    c==0) vs a tangential component (zero-gradient extrapolation).

    Returns (wl, wr): two dicts {offset in (-1,0,1): array(N)} giving
      out[i] = Fl[i] * sum_off wl[off][i] x[i+off]
             + Fr[i] * sum_off wr[off][i] x[i+off]
    where Fl/Fr are the face factors at the low/high face of cell i.
    The +-0.5/h flux-difference factors are folded in. At VELOCITY
    boundaries the boundary-face flux is dropped here and restored as
    an RHS bc term (ComputeConvectionBoundaryConditionVector_Private,
    cnlinearcart2d.c:899-1042).
    """
    N = mesh.N[d]
    c, f, cWg, cEg = _axis_coords(mesh, d)
    h = mesh.widths(d)
    wl = {off: np.zeros(N) for off in (-1, 0, 1)}
    wr = {off: np.zeros(N) for off in (-1, 0, 1)}

    def prev_interior(i, xW):
        # left-face flux, linear interp (cartdiscret.c:305-318)
        xw, xP = f[i], c[i]
        wl[-1][i] = -0.5 / h[i] * (xP - xw) / (xP - xW)
        wl[0][i] = -0.5 / h[i] * (xw - xW) / (xP - xW)

    def next_interior(i, xE):
        # right-face flux (cartdiscret.c:320-333)
        xe, xP = f[i + 1], c[i]
        wr[0][i] = 0.5 / h[i] * (xE - xe) / (xE - xP)
        wr[1][i] = 0.5 / h[i] * (xe - xP) / (xE - xP)

    for i in range(1, N):
        prev_interior(i, c[i - 1])
    for i in range(N - 1):
        next_interior(i, c[i + 1])

    if bc.lo == BCType.PERIODIC:
        prev_interior(0, cWg)
        next_interior(N - 1, cEg)
        return wl, wr

    # low boundary face (cell 0, left face)
    if bc.lo == BCType.PRESSURE_OUTLET or (
        bc.lo == BCType.SYMMETRY and not col_is_normal
    ):
        # zero-gradient extrapolation (cartdiscret.c:335-352). NOTE:
        # the reference's forward variant carries a sign error (its
        # coefficients are -0.5*vf/h times the NEGATED extrapolation
        # weights; the backward variant at cartdiscret.c:354-371 is
        # consistent). We use the correct sign: the low-face flux
        # enters the flux difference with -0.5*vf/h times the
        # zero-slope-quadratic extrapolation weights
        # w0 = h2^2/(h2^2-h1^2), w1 = -h1^2/(h2^2-h1^2).
        h1, h2 = c[0] - f[0], c[1] - f[0]
        wl[0][0] = 0.5 / h[0] * (h2 * h2) / ((h1 + h2) * (h1 - h2))
        wl[1][0] = -0.5 / h[0] * (h1 * h1) / ((h1 + h2) * (h1 - h2))
    # VELOCITY or SYMMETRY-normal: dropped (flux -> bc vector / zero)

    # high boundary face (cell N-1, right face)
    if bc.hi == BCType.PRESSURE_OUTLET or (
        bc.hi == BCType.SYMMETRY and not col_is_normal
    ):
        # (cartdiscret.c:354-371)
        h1, h2 = f[N] - c[N - 1], f[N] - c[N - 2]
        wr[-1][N - 1] = 0.5 / h[N - 1] * (h1 * h1) / ((h1 + h2) * (h1 - h2))
        wr[0][N - 1] = -0.5 / h[N - 1] * (h2 * h2) / ((h1 + h2) * (h1 - h2))

    return wl, wr
