"""Composable finite-difference operator algebra (FlucaFD equivalent;
counterpart of fluca_tpu.ops.fd).

The reference's general-purpose discretization
layer (fluca/src/fd/*): symbolic stencil operators over staggered
Cartesian grids with five combinators — derivative, sum, scale,
composition, second-order TVD (fluca/src/fd/impls/*) — and per-boundary
NONE/DIRICHLET/NEUMANN condition folding
(fluca/src/fd/utils/fdutils.c:252-464).

Design translation: instead of per-point stencil queries
(FlucaFDGetStencil) feeding a matrix-free sweep or matrix assembly,
an operator here IS a static banded stencil: a dict mapping offset
tuples to dense coefficient arrays over the output grid, plus a
constant array carrying folded boundary values. The bands and the
constant are built on the host in float64 numpy exactly as fluca_tpu
builds them, and moved once to each device and dtype an operator is
applied in. Application is shifted-slice arithmetic in torch on that
device (fluca_tpu runs it outside any Pallas kernel, as XLA ops; no
kernel here either); "GetOperator" (assembly) is replaced by
``to_dense`` for tests. Boundary folding happens at
build time via the same Vandermonde construction the reference uses
(derivative.c:84-107), yielding identical stencils for matching
configurations; stencils never depend on the parallel decomposition
(unlike the reference, where folding happens at ghosted local-grid
boundaries).

Grid locations: each axis of input/output is either cell-centered or
face-staggered (the reference's ELEMENT/LEFT/DOWN/BACK combinations,
fdutils.c:15-33) — encoded as a tuple of booleans ``stag[d]``.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ops.banded import shifted
from fluca_tpu_torch.ops.fdcoeffs import fd_weights


class FDBCType(enum.Enum):
    """Reference: FlucaFDBoundaryConditionType (flucafd.h)."""

    NONE = "none"
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"


@dataclass(frozen=True)
class FDBC:
    type: FDBCType = FDBCType.NONE
    value: float = 0.0


def _loc_shape(mesh: CartMesh, stag) -> tuple[int, ...]:
    return tuple(
        mesh.nfaces(d) if stag[d] else mesh.N[d] for d in range(mesh.dim)
    )


def _loc_coords(mesh: CartMesh, d: int, stag_d: bool) -> np.ndarray:
    return mesh.face_coords(d) if stag_d else mesh.centers(d)


@dataclass
class _RawFactor:
    """Unfolded 1-D stencil factor along one axis, with the term
    metadata the reference tracks per stencil point
    (flucafdimpl.h termlink; composition merges it at
    composition.c:3-46: derivative orders add, accuracy = min).
    ``rows`` maps extended output indices (ghost outputs included) to
    {input col: weight}; cols may lie outside the grid."""

    in_stag: bool
    out_stag: bool
    deriv: int
    accu: int
    rows: dict


@dataclass
class StencilOp:
    """A static linear stencil operator + boundary-value constant."""

    mesh: CartMesh
    in_stag: tuple[bool, ...]
    out_stag: tuple[bool, ...]
    bands: dict  # {offset tuple: np.ndarray of out shape}
    const: np.ndarray  # out shape
    # optional raw per-axis factors + the BCs they were built with:
    # kept by derivative() so fd_compose can replicate the reference's
    # compose-raw-then-fold semantics (see fd_compose)
    raw_factors: Optional[dict] = None
    fd_bcs: Optional[list] = None
    # per-axis folded 1-D data (rows + boundary-marker weights),
    # set on composed operators for marker-level introspection
    folded1d: Optional[dict] = None
    # the bands (sorted by offset) and the constant as tensors, by the
    # (device, dtype) they were moved to
    _on_device: dict = field(default_factory=dict, init=False, repr=False,
                             compare=False)

    # -- application ---------------------------------------------------
    def device_arrays(self, device, dtype):
        """The bands, [(offset, tensor)] sorted by offset, and the
        constant (None where it is zero) on ``device`` in ``dtype``:
        moved from the host's float64 arrays on the first request."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (device, dtype)
        arrays = self._on_device.get(key)
        if arrays is None:
            def put(a):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)

            const = put(self.const) if np.any(self.const != 0.0) else None
            arrays = ([(off, put(w)) for off, w in sorted(self.bands.items())], const)
            self._on_device[key] = arrays
        return arrays

    def apply(self, x, include_const: bool = True):
        """y = S x (+ const). x: a tensor at the input location, on the
        device and in the dtype the operator computes in."""
        mesh = self.mesh
        out_shape = _loc_shape(mesh, self.out_stag)
        bands, const = self.device_arrays(x.device, x.dtype)
        y = None
        for off, w in bands:
            xs = x
            for d in range(mesh.dim):
                xs = shifted(
                    xs, d, off[d], out_shape[d], mesh.periodic[d]
                )
            term = w * xs
            y = term if y is None else y + term
        if y is None:
            y = torch.zeros(out_shape, dtype=x.dtype, device=x.device)
        if include_const and const is not None:
            y = y + const
        return y

    def __call__(self, x):
        return self.apply(x)

    # -- introspection (golden-style tests) ---------------------------
    def row(self, idx: tuple[int, ...]):
        """Sorted [(col_index_tuple, coeff)] for one output point, plus
        the constant term — the analogue of the reference's printed
        stencil tables (fluca/tests/fd/fdtest.h:9-41)."""
        mesh = self.mesh
        n_in = _loc_shape(mesh, self.in_stag)
        entries = []
        for off, w in self.bands.items():
            col = []
            ok = True
            for d in range(mesh.dim):
                j = idx[d] + off[d]
                if mesh.periodic[d]:
                    j %= n_in[d]
                elif not (0 <= j < n_in[d]):
                    ok = False
                    break
                col.append(j)
            if not ok:
                continue
            coeff = float(w[idx])
            if coeff != 0.0:
                entries.append((tuple(col), coeff))
        merged: dict = {}
        for col, v in entries:
            merged[col] = merged.get(col, 0.0) + v
        rows = sorted((c, v) for c, v in merged.items() if v != 0.0)
        return rows, float(self.const[idx])

    def row_entries(self, idx: tuple[int, ...]):
        """Marker-level stencil row for composed operators (requires
        ``folded1d``): returns (points {col: w}, markers
        [((axis, side), col_with_boundary_index, w)]) — the analogue
        of the reference's printed composite stencils including
        boundary-value markers."""
        if self.folded1d is None:
            raise ValueError("row_entries needs a derivative-built operator "
                             "(folded1d)")
        mesh = self.mesh
        dim = mesh.dim
        ax_rows = []
        ax_marks = []
        for ax in range(dim):
            if ax in self.folded1d:
                data = self.folded1d[ax]
                row = dict(data["rows"][idx[ax]])
                mks = {
                    side: mk.get(idx[ax], 0.0)
                    for side, mk in data["markers"].items()
                }
            else:
                row = {idx[ax]: 1.0}
                mks = {0: 0.0, 1: 0.0}
            ax_rows.append(row)
            ax_marks.append(mks)

        n_in = _loc_shape(mesh, self.in_stag)
        points: dict = {}
        for combo in itertools.product(*[r.items() for r in ax_rows]):
            col = []
            w = 1.0
            for ax, (c, wc) in enumerate(combo):
                c = c % n_in[ax] if mesh.periodic[ax] else c
                col.append(c)
                w *= wc
            if w != 0.0:
                col = tuple(col)
                points[col] = points.get(col, 0.0) + w

        markers = []
        for ax in range(dim):
            for side, mw in ax_marks[ax].items():
                if mw == 0.0:
                    continue
                bnd = 0 if side == 0 else mesh.N[ax]
                other = [
                    ax_rows[a].items() if a != ax else [(bnd, mw)]
                    for a in range(dim)
                ]
                for combo in itertools.product(*other):
                    col = []
                    w = 1.0
                    for a, (c, wc) in enumerate(combo):
                        if a != ax and mesh.periodic[a]:
                            c = c % n_in[a]
                        col.append(c)
                        w *= wc
                    if w != 0.0:
                        markers.append(((ax, side), tuple(col), w))
        return points, markers

    def to_dense(self) -> np.ndarray:
        mesh = self.mesh
        n_in = _loc_shape(mesh, self.in_stag)
        n_out = _loc_shape(mesh, self.out_stag)
        A = np.zeros((int(np.prod(n_out)), int(np.prod(n_in))))
        for out_idx in np.ndindex(*n_out):
            r = np.ravel_multi_index(out_idx, n_out)
            rows, _ = self.row(out_idx)
            for col, v in rows:
                A[r, np.ravel_multi_index(col, n_in)] += v
        return A


# ----------------------------------------------------------------------
# off-grid folding (fluca/src/fd/utils/fdutils.c:252-464)
# ----------------------------------------------------------------------


def _ghost_coord(x: np.ndarray, j: int, periodic: bool, L: float):
    """Coordinate of (possibly off-grid) index j: periodic wrap with
    L-shifts, else linear extension by the end spacing (the
    reference's FlucaFDGetCoordinate_Internal)."""
    n = len(x)
    if periodic:
        return x[j % n] + (j // n) * L
    if j < 0:
        return x[0] + j * (x[1] - x[0])
    if j >= n:
        return x[n - 1] + (j - (n - 1)) * (x[n - 1] - x[n - 2])
    return x[j]


def _fold_factor_1d(mesh, ax, f: _RawFactor, bc_lo: FDBC, bc_hi: FDBC):
    """Replicate FlucaFDRemoveOffGridPoints_Internal on one 1-D
    factor: every column outside the grid is rewritten per the axis
    BC using npts = deriv_order + accu_order points taken from the
    boundary-side end (fdutils.c:171-196 GetStencilSizeForOffGridPoint
    + :330-460). Returns (rows over in-range outputs, marker weights
    {side: {i: w}})."""
    periodic = mesh.periodic[ax]
    xin = _loc_coords(mesh, ax, f.in_stag)
    n_in = len(xin)
    n_out = mesh.nfaces(ax) if f.out_stag else mesh.N[ax]
    L = mesh.length(ax)
    xb = {0: mesh.faces[ax][0], 1: mesh.faces[ax][-1]}
    npts = max(1, f.deriv + f.accu)
    rows_out = {}
    markers = {0: {}, 1: {}}

    for i in range(n_out):
        row = dict(f.rows[i])
        if periodic:
            rows_out[i] = row
            continue
        for _ in range(100):
            off_cols = [c for c in row if not 0 <= c < n_in]
            if not off_cols:
                break
            col = off_cols[0]
            w = row.pop(col)
            side = 0 if col < 0 else 1
            bc = bc_lo if side == 0 else bc_hi
            xg = _ghost_coord(xin, col, False, L)

            if bc.type == FDBCType.NONE:
                pts = (list(range(npts)) if side == 0
                       else list(range(n_in - npts, n_in)))
                xs = [xin[p] for p in pts]
                A = np.array([[(x - xg) ** r for x in xs]
                              for r in range(npts)])
                b = np.zeros(npts)
                b[0] = 1.0
                coef = np.linalg.solve(A, b)
                for p, cf in zip(pts, coef):
                    row[p] = row.get(p, 0.0) + w * cf
            elif bc.type == FDBCType.DIRICHLET:
                m = npts - 1
                pts = (list(range(m)) if side == 0
                       else list(range(n_in - m, n_in)))
                if f.in_stag:
                    # boundary face IS a grid point: skip duplicate
                    # (fdutils.c:366-371)
                    pts = ([p + 1 for p in pts] if side == 0
                           else [p - 1 for p in pts])
                xs = [xb[side]] + [xin[p] for p in pts]
                A = np.array([[(x - xg) ** r for x in xs]
                              for r in range(len(xs))])
                b = np.zeros(len(xs))
                b[0] = 1.0
                coef = np.linalg.solve(A, b)
                markers[side][i] = markers[side].get(i, 0.0) + w * coef[0]
                for p, cf in zip(pts, coef[1:]):
                    row[p] = row.get(p, 0.0) + w * cf
            elif bc.type == FDBCType.NEUMANN:
                m = npts - 1
                pts = (list(range(m)) if side == 0
                       else list(range(n_in - m, n_in)))
                xs = [xg] + [xin[p] for p in pts]
                A = np.array([[(x - xb[side]) ** r for x in xs]
                              for r in range(len(xs))])
                b = np.zeros(len(xs))
                if len(xs) > 1:
                    b[1] = 1.0
                coef = np.linalg.solve(A, b)
                a_off = coef[0]
                if not abs(a_off) > 1e-14:
                    raise ValueError("Neumann fold singular")
                markers[side][i] = markers[side].get(i, 0.0) + w / a_off
                for p, cf in zip(pts, coef[1:]):
                    row[p] = row.get(p, 0.0) - w * cf / a_off
            else:  # pragma: no cover
                raise ValueError(bc.type)
        rows_out[i] = {c: v for c, v in row.items() if v != 0.0}
    markers = {
        s: {i: v for i, v in mk.items() if v != 0.0}
        for s, mk in markers.items()
    }
    return rows_out, markers


def _assemble_from_factors(mesh, factors, bcs, in_stag, out_stag):
    """Build a StencilOp as the tensor product of folded per-axis 1-D
    factors (axes without a factor act as identity). Boundary-marker
    weights times the BC values flow into the constant."""
    dim = mesh.dim
    out_shape = _loc_shape(mesh, out_stag)
    folded = {}
    for ax, f in factors.items():
        rows, markers = _fold_factor_1d(
            mesh, ax, f, bcs[2 * ax], bcs[2 * ax + 1]
        )
        folded[ax] = {"rows": rows, "markers": markers,
                      "in_stag": f.in_stag}

    # per-axis banded form {offset: 1-D weight array over out index}
    ax_bands = {}
    for ax in range(dim):
        n_out = out_shape[ax]
        if ax not in folded:
            ax_bands[ax] = {0: np.ones(n_out)}
            continue
        bd: dict[int, np.ndarray] = {}
        for i, row in folded[ax]["rows"].items():
            for c, w in row.items():
                off = c - i
                bd.setdefault(off, np.zeros(n_out))[i] += w
        ax_bands[ax] = bd

    def _outer(offs, arrs):
        w = None
        for ax in range(dim):
            shape = [1] * dim
            shape[ax] = -1
            a = arrs[ax].reshape(shape)
            w = a if w is None else w * a
        return np.broadcast_to(w, out_shape).copy()

    bands = {}
    axes_offsets = [sorted(ax_bands[ax]) for ax in range(dim)]
    for offs in itertools.product(*axes_offsets):
        w = _outer(offs, [ax_bands[ax][offs[ax]] for ax in range(dim)])
        if np.any(w != 0.0):
            bands[tuple(offs)] = w

    # constants: marker weight x bc value x row-sums of other axes
    const = np.zeros(out_shape)
    for ax, data in folded.items():
        for side, mk in data["markers"].items():
            if not mk:
                continue
            val = bcs[2 * ax + side].value
            mrow = np.zeros(out_shape[ax])
            for i, w in mk.items():
                mrow[i] = w
            others = []
            for a2 in range(dim):
                if a2 == ax:
                    others.append(mrow)
                else:
                    rs = np.zeros(out_shape[a2])
                    for off, w in ax_bands[a2].items():
                        rs += w
                    others.append(rs)
            const += val * _outer(None, others)

    op = StencilOp(mesh, tuple(in_stag), tuple(out_stag), bands, const)
    op.folded1d = folded
    op.fd_bcs = list(bcs)
    return op


# ----------------------------------------------------------------------
# derivative (fluca/src/fd/impls/derivative/derivative.c)
# ----------------------------------------------------------------------


def derivative(
    mesh: CartMesh,
    direction: int,
    deriv_order: int,
    accu_order: int = 2,
    in_stag=None,
    out_stag=None,
    bcs: Optional[list] = None,
    ghost_width: Optional[int] = None,
) -> StencilOp:
    """d^m/dx_d^m with given accuracy on (possibly non-uniform) grids.

    Stencil width = deriv_order + accu_order points, centered
    (derivative.c:54-58), window shifted for cell<->face transitions
    (derivative.c:59). Near non-periodic boundaries the stencil is
    folded per the axis BCs:
      NONE      — window shifted inward (the off-grid points'
                  polynomial extrapolation, fdutils.c:300-360, reduces
                  to the one-sided rule on the same interior points)
      DIRICHLET — the boundary face point joins the point set; its
                  weight times the bc value becomes a constant term
                  (fdutils.c:362-420)
      NEUMANN   — the polynomial fit is constrained by the prescribed
                  boundary-normal derivative; the constraint weight
                  times the bc value becomes a constant term
                  (fdutils.c:422-464)

    ``bcs`` is a list of 2*dim FDBC (boundary order: left,right,
    down,up,back,front — cart.c:564-591); only the two entries of
    ``direction`` are used by this operator.
    """
    dim = mesh.dim
    d = direction
    in_stag = tuple(in_stag or (False,) * dim)
    out_stag = tuple(out_stag or in_stag)
    for a in range(dim):
        if a != d:
            if in_stag[a] != out_stag[a]:
                raise ValueError(
                    "input/output locations may differ only along the "
                    "derivative direction (derivative.c:24-37)"
                )
    bcs = bcs or [FDBC()] * (2 * dim)
    bc_lo, bc_hi = bcs[2 * d], bcs[2 * d + 1]

    size = deriv_order + accu_order
    # C-style truncation: -(size-1)/2 (derivative.c:58)
    offset_start = -((size - 1) // 2)
    if (not in_stag[d]) and out_stag[d]:
        offset_start -= 1  # derivative.c:59

    periodic = mesh.periodic[d]
    xin = _loc_coords(mesh, d, in_stag[d])
    xout = _loc_coords(mesh, d, out_stag[d])
    n_in, n_out = len(xin), len(xout)
    L = mesh.length(d)
    xb_lo = mesh.faces[d][0]
    xb_hi = mesh.faces[d][-1]

    # Build raw (unfolded) rows over an extended output range, then
    # apply the SAME generic off-grid fold the reference applies at
    # stencil-query time (fdutils.c:252-464) — derivative, composition
    # and sum thus share one folding semantics. Raw windows use
    # ghost-extended coordinates like the reference's precomputed
    # table over the ghosted range (derivative.c:84-107).
    ext = 4
    raw_rows = {}
    for i in range(-ext, n_out + ext):
        x0 = _ghost_coord(xout, i, periodic, L)
        cols = [i + offset_start + c for c in range(size)]
        if periodic and ghost_width is not None:
            # the reference folds points beyond the ghosted local
            # range even on periodic axes (fdutils.c:291-298 with
            # bc_type NONE); for an npts-point window that NONE fold
            # equals shifting the window into [-w, N-1+w] (the unique
            # exact-on-degree rule on the shifted points)
            lo, hi = -ghost_width, n_in - 1 + ghost_width
            shift = max(0, lo - min(cols)) - max(0, max(cols) - hi)
            cols = [c + shift for c in cols]
        xs = [_ghost_coord(xin, c, periodic, L) for c in cols]
        w = fd_weights(xs, x0, deriv_order)
        raw_rows[i] = {c: wc for c, wc in zip(cols, w) if wc != 0.0}

    factor = _RawFactor(in_stag[d], out_stag[d], deriv_order,
                        accu_order, raw_rows)
    op = _assemble_from_factors(mesh, {d: factor}, bcs, in_stag,
                                out_stag)
    op.raw_factors = {d: factor}
    return op


# ----------------------------------------------------------------------
# combinators (fluca/src/fd/impls/{sum,scale,composition}/*)
# ----------------------------------------------------------------------


def fd_sum(*ops: StencilOp) -> StencilOp:
    """Operator sum; dedups identical stencil points
    (fluca/src/fd/impls/sum/sum.c:36-53)."""
    if not ops:
        raise ValueError("fd_sum needs at least one operator")
    first = ops[0]
    for op in ops[1:]:
        if op.in_stag != first.in_stag or op.out_stag != first.out_stag:
            raise ValueError("fd_sum: operators at different locations")
    bands: dict = {}
    const = np.zeros_like(first.const)
    for op in ops:
        for off, w in op.bands.items():
            if off in bands:
                bands[off] = bands[off] + w
            else:
                bands[off] = w.copy()
        const += op.const
    return StencilOp(first.mesh, first.in_stag, first.out_stag, bands, const)


def fd_scale(op: StencilOp, factor) -> StencilOp:
    """Pointwise scaling by a constant or by a field sampled at the
    output location (fluca/src/fd/impls/scale/scale.c). The constant
    term scales too (it is part of the operator's action)."""
    factor = np.asarray(factor, dtype=np.float64)
    bands = {off: w * factor for off, w in op.bands.items()}
    const = op.const * factor
    return StencilOp(op.mesh, op.in_stag, op.out_stag, bands, const)


def fd_compose(outer: StencilOp, inner: StencilOp,
               bcs: Optional[list] = None) -> StencilOp:
    """outer ∘ inner: stencil-of-stencil expansion
    (fluca/src/fd/impls/composition/composition.c:48-72).

    When both operands carry raw 1-D factors (derivative-built), the
    composition follows the reference exactly: the RAW stencils are
    expanded first (reaching through ghost output rows of the inner),
    the per-axis term metadata is merged (derivative orders add,
    accuracy = min, composition.c:18-40), and boundary conditions are
    folded on the COMPOSITE with npts = merged deriv+accu
    (fdutils.c:171-196). Folding the operands separately — the
    fallback below, used for non-derivative operands — loses accuracy
    at boundary rows (the composite fold fits a higher-degree
    polynomial than either factor alone).

    ``bcs`` are the composition's own boundary conditions (the
    reference sets them on the composition object, e.g.
    -comp_flucafd_left_bc_type); defaults to the inner operand's.
    The inner constant term flows through the outer operator into the
    composed constant."""
    if inner.out_stag != outer.in_stag:
        raise ValueError("fd_compose: the inner output is not the outer input")
    mesh = outer.mesh
    dim = mesh.dim

    if outer.raw_factors is not None and inner.raw_factors is not None:
        use_bcs = bcs or inner.fd_bcs or outer.fd_bcs
        use_bcs = use_bcs or [FDBC()] * (2 * dim)
        factors = {
            ax: _RawFactor(f.in_stag, f.out_stag, f.deriv, f.accu,
                           {i: dict(r) for i, r in f.rows.items()})
            for ax, f in inner.raw_factors.items()
        }
        ok = True
        for ax, fo in outer.raw_factors.items():
            if ax not in factors:
                factors[ax] = fo
                continue
            fi = factors[ax]
            rows = {}
            for i, orow in fo.rows.items():
                acc: dict = {}
                valid = True
                for col, w in orow.items():
                    irow = fi.rows.get(col)
                    if irow is None:
                        valid = False
                        break
                    for c2, w2 in irow.items():
                        acc[c2] = acc.get(c2, 0.0) + w * w2
                if valid:
                    rows[i] = acc
            if not all(i in rows for i in range(
                mesh.nfaces(ax) if fo.out_stag else mesh.N[ax]
            )):
                ok = False
                break
            factors[ax] = _RawFactor(
                fi.in_stag, fo.out_stag, fi.deriv + fo.deriv,
                min(fi.accu, fo.accu), rows,
            )
        if ok:
            op = _assemble_from_factors(
                mesh, factors, use_bcs, inner.in_stag, outer.out_stag
            )
            op.raw_factors = factors
            return op
    out_shape = _loc_shape(mesh, outer.out_stag)
    bands: dict = {}
    for aoff, aw in outer.bands.items():
        for boff, bw in inner.bands.items():
            off = tuple(aoff[d] + boff[d] for d in range(dim))
            # inner coeff read at (out_idx + aoff), 0 outside / wrapped
            bw_shift = torch.from_numpy(np.asarray(bw, np.float64))
            for d in range(dim):
                bw_shift = shifted(bw_shift, d, aoff[d], out_shape[d],
                                   mesh.periodic[d])
            w = aw * bw_shift.numpy()
            if off in bands:
                bands[off] = bands[off] + w
            else:
                bands[off] = w
    # composed constant: outer applied to inner.const, plus outer.const
    # (on the host, in float64)
    tmp = StencilOp(mesh, outer.in_stag, outer.out_stag, outer.bands,
                    np.zeros(out_shape))
    const = tmp.apply(torch.from_numpy(np.asarray(inner.const, np.float64))).numpy() \
        + outer.const
    bands = {o: w for o, w in bands.items() if np.any(w != 0.0)}
    return StencilOp(mesh, inner.in_stag, outer.out_stag, bands, const)


def parse_loc(name: str, dim: int) -> tuple[bool, ...]:
    """DMStag-style location names -> stag tuple: 'element', 'left'
    (x-face), 'down' (y-face), 'back' (z-face) and '_'-combinations
    (reference stencil locations, fdutils.c:15-33)."""
    stag = [False] * dim
    if name.lower() in ("element", "elem", ""):
        return tuple(stag)
    for part in name.lower().split("_"):
        axis = {"left": 0, "down": 1, "back": 2}[part]
        if axis >= dim:
            raise ValueError(f"location {part} invalid in {dim}D")
        stag[axis] = True
    return tuple(stag)


def fd_from_options(mesh: CartMesh, opts, prefix: str = "flucafd_"):
    """Build an FD operator from the options database (reference:
    FlucaFDSetFromOptions, fdopts.c:65-108 + per-type options:
    -flucafd_type, -flucafd_dir, -flucafd_deriv_order,
    -flucafd_accu_order, -flucafd_{input,output}_loc,
    -flucafd_<boundary>_bc_type/_value, -flucafd_limiter)."""
    o = opts.sub(prefix)
    fd_type = o.get_str("type", "derivative")
    dim = mesh.dim
    names = ["left", "right", "down", "up", "back", "front"][: 2 * dim]
    bcs = []
    for n in names:
        t = o.get_str(f"{n}_bc_type", "none").lower()
        v = o.get_real(f"{n}_bc_value", 0.0)
        bcs.append(FDBC(FDBCType(t), v))
    in_loc = parse_loc(o.get_str("input_loc", "element"), dim)
    out_loc = parse_loc(o.get_str("output_loc", "element"), dim)
    direction = {"x": 0, "y": 1, "z": 2}[o.get_str("dir", "x").lower()]
    if fd_type == "derivative":
        return derivative(
            mesh, direction,
            o.get_int("deriv_order", 1), o.get_int("accu_order", 2),
            in_stag=in_loc, out_stag=out_loc, bcs=bcs,
        )
    if fd_type == "secondordertvd":
        from fluca_tpu_torch.ops.tvd import TVDOp

        return TVDOp(
            mesh, direction, limiter=o.get_str("limiter", "vanleer"),
            bcs=bcs,
        )
    raise ValueError(f"unknown flucafd type {fd_type!r}")


class ScaledFieldOp:
    """Runtime scaling by a field on the device (reference:
    FlucaFDScaleSetVector, scale.c:256-329): apply = field ⊙ op(x).
    Used where the scale field changes per step (e.g. Burgers
    nonlinearity, tutorials/fd/ex4.c)."""

    def __init__(self, op: StencilOp):
        self.op = op
        self.field = None

    def set_field(self, field):
        self.field = field

    def apply(self, x):
        y = self.op.apply(x)
        return y if self.field is None else self.field * y

    __call__ = apply
