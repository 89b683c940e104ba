"""Matrix-free NS operators over per-axis stencil tables.

Counterpart of fluca_tpu.ns.operators (the reference's assembled
MATNEST blocks, fluca/src/ns/impl/linearcn/cnlinearcart2d.c assembly).
Each operator applies precomputed device coefficient bands as
shifted-slice arithmetic; the momentum block A runs through the fused
momentum kernel (ops/cuda_stencil.py): in 2-D on its 26-plane
coefficient stack, in 3-D on 27-row per-axis bands and the step's face
factors (``apply_A_coeffs``).

Under a rank-held grid (``parallel.mesh.RankGrid``, ``grid=``) every field
is this rank's block (``parallel.mesh.Block``: cells, and faces lo +
hilast), every band its block's rows of the host-f64 tables, and a read
past the block along a split axis comes from the neighbour rank: one
exchange per operator and axis, as wide as the largest band offset
(``parallel.halo.rank_slabs``). The boundary-condition inserts act only
on the ranks that hold that boundary.

Field layout conventions (see fluca_tpu_torch.mesh.cart):
  cell scalar  p  : (N0, N1[, N2])
  cell vector  v  : tuple of dim cell tensors
  face scalar  U  : tuple per axis, U[d] has face_shape(d)
  face vector  vf : nested tuple vf[d][c]

Operators (reference THEORY_GUIDE.md:136-198):
  G   : cell scalar -> cell vector, (dt/rho) * grad p
  L   : cell vector -> cell vector, Laplacian (unscaled)
  C   : cell vector -> cell vector, linearized convection
        (C v)_c = (1/2) d/dx_d (v_c U0_d + v0f_c v_d)   [unscaled]
  B   : cell vector -> face vector, linear interpolation
  T   : cell vector -> face scalar, normal component of B
  Gst : cell scalar -> face scalar, (dt/rho) * face-normal grad
  D   : face scalar -> cell scalar, divergence
  R   : = T G - Gst (Rhie-Chow correction)
  A   : = I + dt C - (mu dt / 2 rho) L (momentum block,
        cnlinearcart2d.c:2056-2067)
"""

from __future__ import annotations

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ns.bc import BCType, validate_bcs
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.ops.banded import (
    AxisStencil,
    apply_axis_stencil,
    broadcast_1d,
    compose_axis_stencils,
)
from fluca_tpu_torch.parallel.halo import rank_slabs
from fluca_tpu_torch.parallel.mesh import Block

# plane order of the fused momentum kernel's coefficient stack
# (csrc/momentum2d.cu): (component, kind, axis) triples with offsets
# -1, 0, +1 each, then the +-2 boundary-row planes of "self"
_STACK_ORDER = (
    (0, "self", 0), (0, "self", 1), (0, "cross", 1),
    (1, "self", 0), (1, "self", 1), (1, "cross", 0),
)


class NSOperators:
    def __init__(self, mesh: CartMesh, bcs, rho, mu, dt, dtype, device, grid=None):
        validate_bcs(mesh, bcs)
        self.mesh = mesh
        # a RankGrid (the operators act on this rank's block), or None
        self.grid = grid
        blk = (Block.whole(mesh.N, mesh.periodic) if grid is None
               else grid.block(mesh.N, mesh.periodic))
        self.block = blk
        self.bcs = list(bcs)
        self.rho = float(rho)
        self.mu = float(mu)
        self.dt = float(dt)
        self.dtype = dtype
        self.device = torch.device(device)
        dim = mesh.dim
        self.dim = dim
        axbcs = T_.axis_bcs(mesh, bcs)
        self.axbcs = axbcs

        def dev(stencil, faces=False):
            d = stencil.axis
            return stencil.device_bands(dim, dtype, self.device,
                                        blk.faces(d) if faces else blk.cells(d))

        def bcast(w, axis):
            return broadcast_1d(self._tensor(np.asarray(w)[blk.cells(axis)]), dim, axis)

        self.g_bands, self.g_bc = [], []
        self.l_bands = [[None] * dim for _ in range(dim)]
        self.l_bc = [[None] * dim for _ in range(dim)]
        self.b_bands = [[None] * dim for _ in range(dim)]
        self.b_insert = [[None] * dim for _ in range(dim)]
        self.gst_bands, self.gst_bc, self.d_bands = [], [], []
        self.r_bands = []
        self.conv_w = []

        for d in range(dim):
            g_st, lo, hi = T_.grad_cell_tables(mesh, d, axbcs[d])
            self.g_bands.append(dev(g_st))
            self.g_bc.append((float(lo), float(hi)))

            for c in range(dim):
                st, blo, bhi = T_.lap_tables(mesh, d, axbcs[d], c)
                self.l_bands[c][d] = dev(st)
                self.l_bc[c][d] = (float(blo), float(bhi))

                sti, ilo, ihi = T_.interp_tables(mesh, d, axbcs[d], c)
                self.b_bands[d][c] = dev(sti, faces=True)
                self.b_insert[d][c] = (ilo, ihi)

            st, lo, hi = T_.gst_tables(mesh, d, axbcs[d])
            self.gst_bands.append(dev(st, faces=True))
            self.gst_bc.append((float(lo), float(hi)))
            self.d_bands.append(dev(T_.div_tables(mesh, d)))

            # Rhie-Chow correction composed into one banded operator
            # per axis: R_d = T_d ∘ G_d - Gst_d (THEORY_GUIDE eq. 11)
            ti_st, _, _ = T_.interp_tables(mesh, d, axbcs[d], d)
            comp = compose_axis_stencils(ti_st, g_st)
            rb = {off: np.array(w) for off, w in comp.as_dict().items()}
            for off, w in st.as_dict().items():
                rb[off] = rb.get(off, np.zeros(mesh.nfaces(d))) - w
            r_st = AxisStencil.from_dict(
                d, mesh.nfaces(d), mesh.periodic[d], rb
            )
            self.r_bands.append(dev(r_st, faces=True))

            variants = {}
            for col_is_normal in (False, True):
                wl, wr = T_.conv_tables(mesh, d, axbcs[d], col_is_normal)
                variants[col_is_normal] = tuple(
                    {
                        o: bcast(w, d)
                        for o, w in wd.items()
                        if np.any(np.asarray(w) != 0.0)
                    }
                    for wd in (wl, wr)
                )
            self.conv_w.append(variants)

        # Laplacian diagonal per component (for Jacobi preconditioning)
        diagL = []
        for c in range(dim):
            tot = np.zeros(blk.cell_shape)
            for d in range(dim):
                st, _, _ = T_.lap_tables(mesh, d, axbcs[d], c)
                w0 = st.as_dict().get(0, np.zeros(mesh.N[d]))[blk.cells(d)]
                shape = [1] * dim
                shape[d] = -1
                tot = tot + w0.reshape(shape)
            diagL.append(self._tensor(tot))
        self.diag_L = tuple(diagL)

        # boundary plane coordinates (cell-transverse positions at the
        # boundary face), one per (axis, side); tensors keep a size-1
        # boundary axis for direct broadcast into boundary slices
        self.plane_coords = [[None, None] for _ in range(dim)]
        for d in range(dim):
            if mesh.periodic[d]:
                continue
            for side in (0, 1):
                coords = []
                for a in range(dim):
                    if a == d:
                        val = mesh.faces[d][0 if side == 0 else mesh.N[d]]
                        arr = np.full((1,), val)
                    else:
                        arr = mesh.centers(a)[blk.cells(a)]
                    shape = [1] * dim
                    shape[a] = -1
                    coords.append(self._tensor(arr.reshape(shape)))
                self.plane_coords[d][side] = tuple(coords)

        # per-axis boundary cell widths (for the convection bc vector)
        self.h_bnd = [
            (float(mesh.widths(d)[0]), float(mesh.widths(d)[-1]))
            for d in range(dim)
        ]

        # the 3-D momentum kernel's band arrays (fixed for the run), and
        # their twin in another coefficient dtype, built on first use
        # (momentum_bands_3d)
        self.mom_bands3d = None
        self._mom_bands3d_twin = None
        if dim == 3:
            self.mom_bands3d = self._momentum_bands(dtype)
        # under a device grid (CNLinearSolver.set_device_grid): the
        # sharded momentum A-apply of parallel/sharded.py, else None
        self.sharded_momentum = None

    def _momentum_bands(self, dtype):
        host = cuda_stencil.build_momentum_bands_3d(
            self.mesh, self.axbcs, self.rho, self.mu, self.dt)
        return cuda_stencil.Momentum3DBands.from_host(
            [B[:, self.block.cells(a)] for a, B in enumerate(host)],
            self.mesh.periodic, dtype, self.device,
        )

    def momentum_bands_3d(self, dtype):
        """The 3-D momentum kernel's bands for fields of ``dtype``, in
        its ``coef_dtype``: ``mom_bands3d`` where that is the solver
        dtype, else a twin built once (float32 bands for the bf16 or
        float32 preconditioner of a float64 solve)."""
        cdt = cuda_stencil.coef_dtype(dtype)
        if cdt == self.dtype:
            return self.mom_bands3d
        if self._mom_bands3d_twin is None:  # the other of f32 and f64
            self._mom_bands3d_twin = self._momentum_bands(cdt)
        return self._mom_bands3d_twin

    def _tensor(self, a):
        return torch.as_tensor(
            np.ascontiguousarray(a), dtype=self.dtype, device=self.device
        )

    def _zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # slice helpers
    # ------------------------------------------------------------------
    def _owns(self, d, side) -> bool:
        """Whether the block holds boundary ``side`` (0 low, 1 high) of a
        non-periodic axis ``d``."""
        return self.block.at_lo(d) if side == 0 else self.block.at_hi(d)

    def _cell_boundary_slice(self, d, side):
        idx = [slice(None)] * self.dim
        idx[d] = slice(0, 1) if side == 0 else slice(self.block.n[d] - 1, None)
        return tuple(idx)

    def _face_boundary_slice(self, d, side):
        nf = self.block.nfaces(d)
        idx = [slice(None)] * self.dim
        idx[d] = slice(0, 1) if side == 0 else slice(nf - 1, None)
        return tuple(idx)

    def _face_factors(self, F, d):
        """Low/high face factor tensors (cell shape) from face tensor F
        along axis d."""
        n = self.block.n[d]
        if self.block.split[d]:
            return F.narrow(d, 0, n), self._apply(((1, 1.0),), F, d, n)
        if self.mesh.periodic[d]:
            return F, torch.roll(F, -1, d)
        return F.narrow(d, 0, n), F.narrow(d, 1, n)

    def _apply(self, bands, x, d, n_out):
        """sum over (off, w) in ``bands`` of w * x[i + off] along ``d`` for
        i < n_out (``apply_axis_stencil``), on a block: along a split axis
        the reads past it come from the neighbour ranks, one exchange as
        wide as the largest offset, with the terms in the same order."""
        if not self.block.split[d]:
            return apply_axis_stencil(bands, x, d, n_out, self.mesh.periodic[d])
        if not bands:
            shape = list(x.shape)
            shape[d] = n_out
            return x.new_zeros(shape)
        lo = max(0, -min(off for off, _ in bands))
        hi = max(0, max(off for off, _ in bands))
        glo, ghi = rank_slabs(x, self.grid, d, self.mesh.periodic[d], lo, hi)
        parts = [t for t in (glo, x, ghi) if t is not None]
        extra = n_out - x.shape[d]
        if extra > 0:
            # face N of a wall's last block reads past the grid: zeros
            shape = list(x.shape)
            shape[d] = extra
            parts.append(x.new_zeros(shape))
        ext = torch.cat(parts, d) if len(parts) > 1 else x
        y = None
        for off, w in bands:
            term = w * ext.narrow(d, lo + off, n_out)
            y = term if y is None else y + term
        return y

    # ------------------------------------------------------------------
    # operator applications
    # ------------------------------------------------------------------
    def apply_G(self, p):
        """(dt/rho) grad p at cell centers -> cell vector."""
        s = self.dt / self.rho
        return tuple(
            s
            * self._apply(self.g_bands[d], p, d, self.block.n[d])
            for d in range(self.dim)
        )

    def apply_L(self, v):
        """Laplacian of each velocity component (unscaled)."""
        out = []
        for c in range(self.dim):
            acc = None
            for d in range(self.dim):
                t = self._apply(self.l_bands[c][d], v[c], d, self.block.n[d])
                acc = t if acc is None else acc + t
            out.append(acc)
        return tuple(out)

    def _conv_band(self, x, wdict, d):
        return self._apply(tuple(wdict.items()), x, d, self.block.n[d])

    def apply_C(self, v, U0, v0f):
        """Linearized convection (unscaled):
        (C v)_c = sum_d [ d/dx_d (v_c U0_d)/2 + d/dx_d (v0f_c v_d)/2 ].
        Reference: ComputeConvectionOperator_Private
        (cnlinearcart2d.c:601-897)."""
        out = []
        for c in range(self.dim):
            acc = None
            for d in range(self.dim):
                wl1, wr1 = self.conv_w[d][c == d]
                wl2, wr2 = self.conv_w[d][True]
                FlU, FrU = self._face_factors(U0[d], d)
                Flv, Frv = self._face_factors(v0f[d][c], d)
                t = (
                    FlU * self._conv_band(v[c], wl1, d)
                    + FrU * self._conv_band(v[c], wr1, d)
                    + Flv * self._conv_band(v[d], wl2, d)
                    + Frv * self._conv_band(v[d], wr2, d)
                )
                acc = t if acc is None else acc + t
            out.append(acc)
        return tuple(out)

    def apply_A(self, v, U0, v0f):
        """Momentum block: A v = v + dt C v - (mu dt / 2 rho) L v
        (cnlinearcart2d.c:2056-2067), on the banded tables."""
        Cv = self.apply_C(v, U0, v0f)
        Lv = self.apply_L(v)
        a = self.dt
        b = 0.5 * self.mu * self.dt / self.rho
        return tuple(
            v[c] + a * Cv[c] - b * Lv[c] for c in range(self.dim)
        )

    def diag_A(self, U0, v0f):
        """Diagonal of A (for Jacobi-preconditioned momentum solves)."""
        out = []
        b = 0.5 * self.mu * self.dt / self.rho
        for c in range(self.dim):
            diagC = None
            for d in range(self.dim):
                wl1, wr1 = self.conv_w[d][c == d]
                FlU, FrU = self._face_factors(U0[d], d)
                t = FlU * wl1.get(0, 0.0) + FrU * wr1.get(0, 0.0)
                if c == d:
                    wl2, wr2 = self.conv_w[d][True]
                    Flv, Frv = self._face_factors(v0f[d][c], d)
                    t = t + Flv * wl2.get(0, 0.0) + Frv * wr2.get(0, 0.0)
                diagC = t if diagC is None else diagC + t
            out.append(1.0 + self.dt * diagC - b * self.diag_L[c])
        return tuple(out)

    # ------------------------------------------------------------------
    # momentum coefficient fields, once per step
    # ------------------------------------------------------------------
    def build_momentum_coeffs(self, U0, v0f):
        """Collapse A = I + dt C - (mu dt/2rho) L into dense coefficient
        fields {"self": [c][d]{off: field}, "cross": [c][d]{off: field}}
        (the reference's dict form; the 2-D step consumes its stacked
        packing, ``build_momentum_coeffs_stacked``)."""
        dim = self.dim
        dt = self.dt
        b = 0.5 * self.mu * self.dt / self.rho
        shape = self.block.cell_shape
        selfc = [[None] * dim for _ in range(dim)]
        cross = [[None] * dim for _ in range(dim)]
        for c in range(dim):
            for d in range(dim):
                lap = dict(self.l_bands[c][d])
                wl1, wr1 = self.conv_w[d][c == d]
                FlU, FrU = self._face_factors(U0[d], d)
                wl2, wr2 = self.conv_w[d][True]
                Flv, Frv = self._face_factors(v0f[d][c], d)
                offs = sorted(
                    set(lap) | set(wl1) | set(wr1) | set(wl2) | set(wr2)
                )
                S, X = {}, {}
                for off in offs:
                    s = None
                    if off in lap:
                        s = _acc(s, -b * lap[off])
                    if off in wl1:
                        s = _acc(s, dt * FlU * wl1[off])
                    if off in wr1:
                        s = _acc(s, dt * FrU * wr1[off])
                    x = None
                    if off in wl2:
                        x = _acc(x, dt * Flv * wl2[off])
                    if off in wr2:
                        x = _acc(x, dt * Frv * wr2[off])
                    if c == d and x is not None:
                        s = _acc(s, x)
                        x = None
                    if s is not None:
                        S[off] = s.expand(shape)
                    if x is not None:
                        X[off] = x.expand(shape)
                if c == d or 0 not in S:
                    S[0] = S.get(0, self._zeros(shape))
                selfc[c][d] = S
                cross[c][d] = X
        # identity on the diagonal, folded into axis 0's center plane
        for c in range(dim):
            selfc[c][0] = dict(selfc[c][0])
            selfc[c][0][0] = selfc[c][0].get(0, self._zeros(shape)) + 1.0
        return {"self": selfc, "cross": cross}

    def build_momentum_coeffs_stacked(self, U0, v0f):
        """Pack the coefficient fields into the (26, N0, N1) layout of
        the fused momentum kernel: 18 tridiagonal planes + 8
        boundary-row +-2 planes (csrc/momentum2d.cu)."""
        if self.dim != 2:
            raise ValueError("the stacked momentum coefficients are 2-D; "
                             "3-D uses build_momentum_factors_3d")
        C = self.build_momentum_coeffs(U0, v0f)
        zeros = self._zeros(self.block.cell_shape)
        planes = []
        for c, kind, d in _STACK_ORDER:
            table = C[kind][c][d]
            for off in (-1, 0, 1):
                planes.append(table.get(off, zeros))
        for c in range(2):
            for d in range(2):
                table = C["self"][c][d]
                for off in (-2, 2):
                    planes.append(table.get(off, zeros))
        return torch.stack(planes)

    def build_momentum_factors_3d(self, U0, v0f, dtype=None):
        """The step's face factors for the fused 3-D A-apply (a dtype
        and contiguity pass over U0 and v0f), in ``dtype`` (the solver
        dtype if None), for the bands ``momentum_bands_3d(dtype)``."""
        dtype = self.dtype if dtype is None else dtype
        return cuda_stencil.Momentum3DFactors.from_faces(
            U0, v0f, self.momentum_bands_3d(dtype), dtype
        )

    def build_momentum_operator(self, U0, v0f):
        """The per-step coefficients ``apply_A_coeffs`` takes: the 2-D
        plane stack, or the 3-D face factors (under a device grid with
        their hi face planes, ``ShardedMomentum3D.prep``)."""
        if self.dim == 2:
            return self.build_momentum_coeffs_stacked(U0, v0f)
        if self.sharded_momentum is not None:
            return self.sharded_momentum.prep(U0, v0f)
        return self.build_momentum_factors_3d(U0, v0f)

    def apply_A_coeffs(self, v, coeffs):
        """A v through the fused momentum kernel (its plain version for
        CPU tensors), on the 2-D plane stack or the 3-D face factors,
        whose dtype picks the bands (``momentum_bands_3d``); under a device
        grid through its sharded form, on the solver dtype's
        coefficients."""
        if self.sharded_momentum is not None:
            if self.dim == 2:
                return self.sharded_momentum(coeffs, v[0], v[1])
            return self.sharded_momentum.apply(v, coeffs)
        if self.dim == 2:
            return cuda_stencil.momentum2d(
                coeffs, v[0], v[1], self.mesh.periodic
            )
        return cuda_stencil.momentum3d(
            self.momentum_bands_3d(coeffs.U0[0].dtype), coeffs, v
        )

    def apply_B(self, v):
        """Interpolate cell vector to all faces -> face vector
        vf[d][c]."""
        return tuple(
            tuple(
                self._apply(self.b_bands[d][c], v[c], d, self.block.nfaces(d))
                for c in range(self.dim)
            )
            for d in range(self.dim)
        )

    def apply_T(self, v):
        """Face-normal interpolation -> face scalar."""
        return tuple(
            self._apply(self.b_bands[d][d], v[d], d, self.block.nfaces(d))
            for d in range(self.dim)
        )

    def apply_Gst(self, p):
        """(dt/rho) face-normal grad p -> face scalar."""
        s = self.dt / self.rho
        return tuple(
            s
            * self._apply(self.gst_bands[d], p, d, self.block.nfaces(d))
            for d in range(self.dim)
        )

    def apply_D(self, U):
        """Divergence of face-normal velocity -> cell scalar."""
        acc = None
        for d in range(self.dim):
            t = self._apply(self.d_bands[d], U[d], d, self.block.n[d])
            acc = t if acc is None else acc + t
        return acc

    def apply_R(self, p):
        """Rhie-Chow correction R p = T G p - Gst p (THEORY_GUIDE
        eq. 11), through the per-axis composed bands."""
        s = self.dt / self.rho
        return tuple(
            s
            * self._apply(self.r_bands[d], p, d, self.block.nfaces(d))
            for d in range(self.dim)
        )

    def apply_DGst(self, p):
        """D Gst p — the pressure-Poisson operator (times dt/rho)."""
        return self.apply_D(self.apply_Gst(p))

    # ------------------------------------------------------------------
    # boundary-condition RHS vectors (time-dependent)
    # ------------------------------------------------------------------
    def _eval_velocity(self, d, side, t):
        bc = self.bcs[2 * d + side]
        return bc.velocity(t, self.plane_coords[d][side])

    def _eval_pressure(self, d, side, t):
        bc = self.bcs[2 * d + side]
        return bc.pressure(t, self.plane_coords[d][side])

    def _plane(self, val, like):
        """``val`` (tensor or number) broadcast to ``like``'s shape in
        the compute dtype."""
        return torch.as_tensor(
            val, dtype=self.dtype, device=self.device
        ).expand(like.shape)

    def bc_G(self, t):
        """Pressure-gradient bc vector (unscaled; caller multiplies
        dt/rho), cnlinearcart2d.c:155-290."""
        out = [self._zeros(self.block.cell_shape) for _ in range(self.dim)]
        for d in range(self.dim):
            if self.mesh.periodic[d]:
                continue
            for side in (0, 1):
                coef = self.g_bc[d][side]
                if coef == 0.0 or not self._owns(d, side):
                    continue
                pb = self._eval_pressure(d, side, t)
                sl = self._cell_boundary_slice(d, side)
                out[d][sl] += coef * self._plane(pb, out[d][sl])
        return tuple(out)

    def bc_L(self, t):
        """Laplacian bc vector (cnlinearcart2d.c:450-599)."""
        out = [self._zeros(self.block.cell_shape) for _ in range(self.dim)]
        for d in range(self.dim):
            if self.mesh.periodic[d]:
                continue
            for side in (0, 1):
                if self.bcs[2 * d + side].type != BCType.VELOCITY \
                        or not self._owns(d, side):
                    continue
                vb = self._eval_velocity(d, side, t)
                sl = self._cell_boundary_slice(d, side)
                for c in range(self.dim):
                    coef = self.l_bc[c][d][side]
                    if coef == 0.0:
                        continue
                    out[c][sl] += coef * self._plane(vb[c], out[c][sl])
        return tuple(out)

    def bc_C(self, t0, t1):
        """Convection bc vector: boundary-face flux of the linearized
        convection at VELOCITY boundaries (cnlinearcart2d.c:899-1042).
        Sign is - at low faces, + at high faces."""
        out = [self._zeros(self.block.cell_shape) for _ in range(self.dim)]
        for d in range(self.dim):
            if self.mesh.periodic[d]:
                continue
            for side in (0, 1):
                if self.bcs[2 * d + side].type != BCType.VELOCITY \
                        or not self._owns(d, side):
                    continue
                vb0 = self._eval_velocity(d, side, t0)
                vb1 = self._eval_velocity(d, side, t1)
                h = self.h_bnd[d][side]
                sgn = -1.0 if side == 0 else 1.0
                sl = self._cell_boundary_slice(d, side)
                for c in range(self.dim):
                    val = (
                        sgn * 0.5 * (vb1[c] * vb0[d] + vb0[c] * vb1[d]) / h
                    )
                    out[c][sl] += self._plane(val, out[c][sl])
        return tuple(out)

    def _bc_face_insert(self, t, comps):
        """Shared helper for bc_B/bc_T: prescribed face values at
        VELOCITY boundaries (SYMMETRY prescribes 0, already zero)."""
        out = []
        for d in range(self.dim):
            row = []
            for c in comps(d):
                arr = self._zeros(self.block.face_shape(d))
                if not self.mesh.periodic[d]:
                    for side in (0, 1):
                        if self.bcs[2 * d + side].type != BCType.VELOCITY:
                            continue
                        if not self.b_insert[d][c][side] or not self._owns(d, side):
                            continue
                        vb = self._eval_velocity(d, side, t)
                        sl = self._face_boundary_slice(d, side)
                        arr[sl] = self._plane(vb[c], arr[sl])
                row.append(arr)
            out.append(tuple(row))
        return out

    def bc_B(self, t):
        """Face-vector interpolation bc (cnlinearcart2d.c:1209-1329)."""
        return tuple(self._bc_face_insert(t, lambda d: range(self.dim)))

    def bc_T(self, t):
        """Face-normal interpolation bc (cnlinearcart2d.c:1476-1587)."""
        res = self._bc_face_insert(t, lambda d: (d,))
        return tuple(r[0] for r in res)

    def bc_Gst(self, t):
        """Staggered pressure-gradient bc vector (unscaled;
        cnlinearcart2d.c:1797-1931)."""
        out = []
        for d in range(self.dim):
            arr = self._zeros(self.block.face_shape(d))
            if not self.mesh.periodic[d]:
                for side in (0, 1):
                    coef = self.gst_bc[d][side]
                    if coef == 0.0 or not self._owns(d, side):
                        continue
                    pb = self._eval_pressure(d, side, t)
                    sl = self._face_boundary_slice(d, side)
                    arr[sl] = coef * self._plane(pb, arr[sl])
            out.append(arr)
        return tuple(out)

    # ------------------------------------------------------------------
    @property
    def has_pressure_outlet(self) -> bool:
        """Pressure nullspace exists unless some boundary pins the
        pressure (reference nsbasic.c:215-244)."""
        return any(b.type == BCType.PRESSURE_OUTLET for b in self.bcs)


def _acc(s, t):
    return t if s is None else s + t
