"""Matrix-free NS operators of the plain reference over per-axis stencil
tables: a frozen copy of the port's ``ns/operators.py`` on one whole
grid, with the momentum block A applied on the banded tables
(``apply_A``: A v = v + dt C v - (mu dt / 2 rho) L v), never through a
packed coefficient layout or a kernel.

Field layout: cell scalar p (N0, N1, N2); cell vector v a tuple of dim
cell tensors; face scalar U a tuple per axis (U[d] has face_shape(d));
face vector vf nested vf[d][c].

Operators (THEORY_GUIDE eq. 11-13 of the solver):
  G   : cell scalar -> cell vector, (dt/rho) grad p
  L   : cell vector -> cell vector, Laplacian (unscaled)
  C   : cell vector -> cell vector, linearized convection
  B   : cell vector -> face vector, linear interpolation
  T   : cell vector -> face scalar, normal component of B
  Gst : cell scalar -> face scalar, (dt/rho) face-normal grad
  D   : face scalar -> cell scalar, divergence
  R   : = T G - Gst (Rhie-Chow correction)
"""

from __future__ import annotations

import numpy as np
import torch

from . import tables as T_
from .banded import AxisStencil, apply_axis_stencil, broadcast_1d, compose_axis_stencils
from .bc import BCType, validate_bcs
from .mesh import CartMesh


class NSOperators:
    def __init__(self, mesh: CartMesh, bcs, rho, mu, dt, dtype, device):
        validate_bcs(mesh, bcs)
        self.mesh = mesh
        self.bcs = list(bcs)
        self.rho, self.mu, self.dt = float(rho), float(mu), float(dt)
        self.dtype = dtype
        self.device = torch.device(device)
        dim = mesh.dim
        self.dim = dim
        axbcs = T_.axis_bcs(mesh, bcs)
        self.axbcs = axbcs

        def dev(stencil):
            return stencil.device_bands(dim, dtype, self.device)

        def bcast(w, axis):
            return broadcast_1d(self._tensor(np.asarray(w)), dim, axis)

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
                self.b_bands[d][c] = dev(sti)
                self.b_insert[d][c] = (ilo, ihi)
            st, lo, hi = T_.gst_tables(mesh, d, axbcs[d])
            self.gst_bands.append(dev(st))
            self.gst_bc.append((float(lo), float(hi)))
            self.d_bands.append(dev(T_.div_tables(mesh, d)))
            # R_d = T_d G_d - Gst_d, composed into one banded operator
            ti_st, _, _ = T_.interp_tables(mesh, d, axbcs[d], d)
            comp = compose_axis_stencils(ti_st, g_st)
            rb = {off: np.array(w) for off, w in comp.as_dict().items()}
            for off, w in st.as_dict().items():
                rb[off] = rb.get(off, np.zeros(mesh.nfaces(d))) - w
            self.r_bands.append(dev(AxisStencil.from_dict(d, mesh.nfaces(d),
                                                          mesh.periodic[d], rb)))
            variants = {}
            for col_is_normal in (False, True):
                wl, wr = T_.conv_tables(mesh, d, axbcs[d], col_is_normal)
                variants[col_is_normal] = tuple(
                    {o: bcast(w, d) for o, w in wd.items() if np.any(np.asarray(w) != 0.0)}
                    for wd in (wl, wr))
            self.conv_w.append(variants)

        diagL = []
        for c in range(dim):
            tot = np.zeros(mesh.cell_shape)
            for d in range(dim):
                st, _, _ = T_.lap_tables(mesh, d, axbcs[d], c)
                w0 = st.as_dict().get(0, np.zeros(mesh.N[d]))
                shape = [1] * dim
                shape[d] = -1
                tot = tot + w0.reshape(shape)
            diagL.append(self._tensor(tot))
        self.diag_L = tuple(diagL)

        # boundary plane coordinates, one per (axis, side), with a size-1
        # boundary axis
        self.plane_coords = [[None, None] for _ in range(dim)]
        for d in range(dim):
            if mesh.periodic[d]:
                continue
            for side in (0, 1):
                coords = []
                for a in range(dim):
                    if a == d:
                        arr = np.full((1,), mesh.faces[d][0 if side == 0 else mesh.N[d]])
                    else:
                        arr = mesh.centers(a)
                    shape = [1] * dim
                    shape[a] = -1
                    coords.append(self._tensor(arr.reshape(shape)))
                self.plane_coords[d][side] = tuple(coords)
        self.h_bnd = [(float(mesh.widths(d)[0]), float(mesh.widths(d)[-1]))
                      for d in range(dim)]

    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype, device=self.device)

    def _zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _cell_boundary_slice(self, d, side):
        idx = [slice(None)] * self.dim
        idx[d] = slice(0, 1) if side == 0 else slice(self.mesh.N[d] - 1, None)
        return tuple(idx)

    def _face_boundary_slice(self, d, side):
        nf = self.mesh.nfaces(d)
        idx = [slice(None)] * self.dim
        idx[d] = slice(0, 1) if side == 0 else slice(nf - 1, None)
        return tuple(idx)

    def _face_factors(self, F, d):
        """Low/high face factors (cell shape) of face tensor F along d."""
        n = self.mesh.N[d]
        if self.mesh.periodic[d]:
            return F, torch.roll(F, -1, d)
        return F.narrow(d, 0, n), F.narrow(d, 1, n)

    def _apply(self, bands, x, d, n_out):
        return apply_axis_stencil(bands, x, d, n_out, self.mesh.periodic[d])

    # -- operator applications -------------------------------------------
    def apply_G(self, p):
        s = self.dt / self.rho
        return tuple(s * self._apply(self.g_bands[d], p, d, self.mesh.N[d])
                     for d in range(self.dim))

    def apply_L(self, v):
        out = []
        for c in range(self.dim):
            acc = None
            for d in range(self.dim):
                t = self._apply(self.l_bands[c][d], v[c], d, self.mesh.N[d])
                acc = t if acc is None else acc + t
            out.append(acc)
        return tuple(out)

    def _conv_band(self, x, wdict, d):
        return self._apply(tuple(wdict.items()), x, d, self.mesh.N[d])

    def apply_C(self, v, U0, v0f):
        """(C v)_c = sum_d [ d/dx_d (v_c U0_d)/2 + d/dx_d (v0f_c v_d)/2 ]."""
        out = []
        for c in range(self.dim):
            acc = None
            for d in range(self.dim):
                wl1, wr1 = self.conv_w[d][c == d]
                wl2, wr2 = self.conv_w[d][True]
                FlU, FrU = self._face_factors(U0[d], d)
                Flv, Frv = self._face_factors(v0f[d][c], d)
                t = (FlU * self._conv_band(v[c], wl1, d)
                     + FrU * self._conv_band(v[c], wr1, d)
                     + Flv * self._conv_band(v[d], wl2, d)
                     + Frv * self._conv_band(v[d], wr2, d))
                acc = t if acc is None else acc + t
            out.append(acc)
        return tuple(out)

    def apply_A(self, v, U0, v0f):
        """A v = v + dt C v - (mu dt / 2 rho) L v."""
        Cv = self.apply_C(v, U0, v0f)
        Lv = self.apply_L(v)
        a = self.dt
        b = 0.5 * self.mu * self.dt / self.rho
        return tuple(v[c] + a * Cv[c] - b * Lv[c] for c in range(self.dim))

    def diag_A(self, U0, v0f):
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

    def apply_B(self, v):
        return tuple(tuple(self._apply(self.b_bands[d][c], v[c], d, self.mesh.nfaces(d))
                           for c in range(self.dim)) for d in range(self.dim))

    def apply_T(self, v):
        return tuple(self._apply(self.b_bands[d][d], v[d], d, self.mesh.nfaces(d))
                     for d in range(self.dim))

    def apply_Gst(self, p):
        s = self.dt / self.rho
        return tuple(s * self._apply(self.gst_bands[d], p, d, self.mesh.nfaces(d))
                     for d in range(self.dim))

    def apply_D(self, U):
        acc = None
        for d in range(self.dim):
            t = self._apply(self.d_bands[d], U[d], d, self.mesh.N[d])
            acc = t if acc is None else acc + t
        return acc

    def apply_R(self, p):
        s = self.dt / self.rho
        return tuple(s * self._apply(self.r_bands[d], p, d, self.mesh.nfaces(d))
                     for d in range(self.dim))

    # -- boundary-condition RHS vectors -----------------------------------
    def _eval_velocity(self, d, side, t):
        return self.bcs[2 * d + side].velocity(t, self.plane_coords[d][side])

    def _eval_pressure(self, d, side, t):
        return self.bcs[2 * d + side].pressure(t, self.plane_coords[d][side])

    def _plane(self, val, like):
        return torch.as_tensor(val, dtype=self.dtype, device=self.device).expand(like.shape)

    def bc_G(self, t):
        out = [self._zeros(self.mesh.cell_shape) for _ in range(self.dim)]
        for d in range(self.dim):
            if self.mesh.periodic[d]:
                continue
            for side in (0, 1):
                coef = self.g_bc[d][side]
                if coef == 0.0:
                    continue
                pb = self._eval_pressure(d, side, t)
                sl = self._cell_boundary_slice(d, side)
                out[d][sl] += coef * self._plane(pb, out[d][sl])
        return tuple(out)

    def bc_L(self, t):
        out = [self._zeros(self.mesh.cell_shape) for _ in range(self.dim)]
        for d in range(self.dim):
            if self.mesh.periodic[d]:
                continue
            for side in (0, 1):
                if self.bcs[2 * d + side].type != BCType.VELOCITY:
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
        out = [self._zeros(self.mesh.cell_shape) for _ in range(self.dim)]
        for d in range(self.dim):
            if self.mesh.periodic[d]:
                continue
            for side in (0, 1):
                if self.bcs[2 * d + side].type != BCType.VELOCITY:
                    continue
                vb0 = self._eval_velocity(d, side, t0)
                vb1 = self._eval_velocity(d, side, t1)
                h = self.h_bnd[d][side]
                sgn = -1.0 if side == 0 else 1.0
                sl = self._cell_boundary_slice(d, side)
                for c in range(self.dim):
                    val = sgn * 0.5 * (vb1[c] * vb0[d] + vb0[c] * vb1[d]) / h
                    out[c][sl] += self._plane(val, out[c][sl])
        return tuple(out)

    def _bc_face_insert(self, t, comps):
        out = []
        for d in range(self.dim):
            row = []
            for c in comps(d):
                arr = self._zeros(self.mesh.face_shape(d))
                if not self.mesh.periodic[d]:
                    for side in (0, 1):
                        if self.bcs[2 * d + side].type != BCType.VELOCITY:
                            continue
                        if not self.b_insert[d][c][side]:
                            continue
                        vb = self._eval_velocity(d, side, t)
                        sl = self._face_boundary_slice(d, side)
                        arr[sl] = self._plane(vb[c], arr[sl])
                row.append(arr)
            out.append(tuple(row))
        return out

    def bc_B(self, t):
        return tuple(self._bc_face_insert(t, lambda d: range(self.dim)))

    def bc_T(self, t):
        return tuple(r[0] for r in self._bc_face_insert(t, lambda d: (d,)))

    def bc_Gst(self, t):
        out = []
        for d in range(self.dim):
            arr = self._zeros(self.mesh.face_shape(d))
            if not self.mesh.periodic[d]:
                for side in (0, 1):
                    coef = self.gst_bc[d][side]
                    if coef == 0.0:
                        continue
                    pb = self._eval_pressure(d, side, t)
                    sl = self._face_boundary_slice(d, side)
                    arr[sl] = coef * self._plane(pb, arr[sl])
            out.append(arr)
        return tuple(out)

    @property
    def has_pressure_outlet(self) -> bool:
        return any(b.type == BCType.PRESSURE_OUTLET for b in self.bcs)
