"""Second-order TVD face interpolation (deferred correction; counterpart
of fluca_tpu.ops.tvd).

Reference: fluca/src/fd/impls/secondordertvd/secondordertvd.c. Output
lives on faces along ``direction``; input is cell-centered. For face i
with face velocity V[i]:

  V > 0: upwind cell u = i-1, downwind d = i,
         r = grad[i-1] / grad[i],   alpha = alpha_plus[i]
  V <= 0: upwind cell u = i, downwind d = i-1,
         r = grad[i+1] / grad[i],   alpha = alpha_minus[i]

  phi_face = phi_u + alpha * psi(r) * (phi_d - phi_u)

where grad is a 2-point face-centered gradient of the current solution
(secondordertvd.c:77-80,150-185) and alpha_plus/minus are the
non-uniform-grid interpolation factors (secondordertvd.c:82-128). The
upwind term is the linear part; the limited correction enters as a
CONSTANT term computed from the current solution — the reference's
deferred-correction trick (secondordertvd.c:283-289), which keeps the
assembled operator linear. Value-dependent upwinding is expressed with
``torch.where`` masks, on the device of the fields.

At non-periodic boundary faces the reference emits a ghost-cell
average that its BC folding turns into: the Dirichlet value; a
Neumann-consistent one-sided value; or a linear extrapolation (NONE)
— implemented here directly (secondordertvd.c:235-248,298-311 +
fdutils.c folding).
"""

from __future__ import annotations

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ops import fd as fdmod
from fluca_tpu_torch.ops.banded import shifted
from fluca_tpu_torch.ops.fd import FDBC, FDBCType
from fluca_tpu_torch.ops.limiters import limiter_registry


def _host(a) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


class TVDOp:
    def __init__(
        self,
        mesh: CartMesh,
        direction: int,
        limiter="vanleer",
        bcs=None,
    ):
        self.mesh = mesh
        self.d = int(direction)
        self.limiter = (
            limiter_registry.get(limiter)
            if isinstance(limiter, str)
            else limiter
        )
        dim = mesh.dim
        self.bcs = bcs or [FDBC()] * (2 * dim)
        d = self.d
        self.periodic = mesh.periodic[d]
        out_stag = tuple(a == d for a in range(dim))
        # internal 2-point face gradient with the same BCs
        # (secondordertvd.c:77-80)
        self.grad = fdmod.derivative(
            mesh, d, deriv_order=1, accu_order=1,
            in_stag=(False,) * dim, out_stag=out_stag, bcs=self.bcs,
        )
        self.out_stag = out_stag

        # alpha factors per face (secondordertvd.c:108-127)
        nf = mesh.nfaces(d)
        c = mesh.centers(d)
        f = mesh.face_coords(d)
        L = mesh.length(d)
        ap = np.full(nf, 0.5)
        am = np.full(nf, 0.5)
        for i in range(nf):
            if not self.periodic and (i == 0 or i == mesh.N[d]):
                continue
            x_face = f[i]
            x_left = c[i - 1] if i > 0 else c[-1] - L
            x_right = c[i % mesh.N[d]]
            dx = x_right - x_left
            if abs(dx) > 1e-14:
                ap[i] = (x_face - x_left) / dx
                am[i] = (x_right - x_face) / dx
        self.alpha_plus = ap
        self.alpha_minus = am
        self._on_device = {}

    # ------------------------------------------------------------------
    def _alphas(self, device, dtype):
        """alpha_plus, alpha_minus on ``device`` in ``dtype`` (moved from
        the host's float64 arrays on the first request)."""
        key = (torch.device(device), dtype)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.as_tensor(a, dtype=dtype, device=device)
                for a in (self.alpha_plus, self.alpha_minus))
        return self._on_device[key]

    def _shift_face(self, arr, off):
        """Face-array shift along the tvd axis."""
        nf = self.mesh.nfaces(self.d)
        return shifted(arr, self.d, off, nf, self.periodic)

    def _cell_at_face(self, phi, off):
        """phi[cell i + off] viewed at face index i."""
        nf = self.mesh.nfaces(self.d)
        return shifted(phi, self.d, off, nf, self.periodic)

    def apply(self, x, vel, phi=None):
        """Limited face interpolation. ``x`` is the linear-part input,
        ``vel`` the face velocity field, ``phi`` the current solution
        for the deferred correction (defaults to x)."""
        if phi is None:
            phi = x
        mesh, d = self.mesh, self.d
        dim = mesh.dim
        dtype = x.dtype

        grad = self.grad.apply(phi)
        g_prev = self._shift_face(grad, -1)
        g_next = self._shift_face(grad, +1)

        xm1 = self._cell_at_face(x, -1)  # x[i-1] at face i
        x0 = self._cell_at_face(x, 0)  # x[i]
        pm1 = self._cell_at_face(phi, -1)
        p0 = self._cell_at_face(phi, 0)

        def safe_r(num, den):
            return torch.where(torch.abs(den) > 1e-30, num / den,
                               torch.ones_like(num))

        shp = [1] * dim
        shp[d] = -1
        ap, am = self._alphas(x.device, dtype)
        ap = ap.reshape(shp)
        am = am.reshape(shp)

        pos = vel > 0
        r = torch.where(pos, safe_r(g_prev, grad), safe_r(g_next, grad))
        psi = self.limiter(r)
        lin = torch.where(pos, xm1, x0)
        corr = torch.where(
            pos, ap * psi * (p0 - pm1), am * psi * (pm1 - p0)
        )
        out = lin + corr

        if not self.periodic:
            out = self._fold_boundary_faces(out, x)
        return out

    def _fold_boundary_faces(self, out, x):
        """Boundary-face values per BC type (see module docstring)."""
        mesh, d = self.mesh, self.d
        dim = mesh.dim
        N = mesh.N[d]
        c = mesh.centers(d)
        f = mesh.faces[d]
        dtype = out.dtype

        def face_value(side):
            bc = self.bcs[2 * d + side]
            i0 = 0 if side == 0 else N - 1  # nearest cell
            i1 = 1 if side == 0 else N - 2
            xb = f[0] if side == 0 else f[N]
            sl0 = [slice(None)] * dim
            sl0[d] = slice(i0, i0 + 1)
            sl1 = [slice(None)] * dim
            sl1[d] = slice(i1, i1 + 1)
            x0 = x[tuple(sl0)]
            x1 = x[tuple(sl1)]
            if bc.type == FDBCType.DIRICHLET:
                return torch.full_like(x0, bc.value)
            if bc.type == FDBCType.NEUMANN:
                # phi_face = phi_0 - (c0 - xb) * dphi/dn (outward sign
                # handled by coordinate difference)
                return x0 - (c[i0] - xb) * bc.value
            # NONE: linear extrapolation from the two nearest cells
            w1 = (xb - c[i0]) / (c[i1] - c[i0])
            return x0 * (1.0 - w1) + x1 * w1

        idx_lo = [slice(None)] * dim
        idx_lo[d] = 0
        idx_hi = [slice(None)] * dim
        idx_hi[d] = mesh.nfaces(d) - 1
        first = tuple([slice(None)] * d + [0] + [slice(None)] * (dim - d - 1))
        out = out.clone()
        out[tuple(idx_lo)] = face_value(0)[first].to(dtype)
        out[tuple(idx_hi)] = face_value(1)[first].to(dtype)
        return out

    def reference_stencil(self, i: int, vel, phi):
        """The printed stencil decomposition exactly as the reference
        emits it (FlucaFDGetStencilRaw_SecondOrderTVD,
        secondordertvd.c:187-356, + fdutils folding), for golden
        parity tests (1-D).

        Returns a list of entries: ('pt', col, w), ('bc', side, w),
        ('const', value).

        NOTE the reference quirk this reproduces: at an OUTFLOW
        boundary face (vel > 0 at the high face / vel <= 0 at the low
        face) the deferred-correction constant reads the downwind
        ghost cell of its local vector, which is never scattered at a
        physical boundary and is zero — so the emitted face value is
        ~0 regardless of the BC. Our apply() replaces outflow boundary
        faces with the BC-consistent face value instead
        (_fold_boundary_faces); tutorial physics checks rely on that.
        """
        if self.mesh.dim != 1:
            raise ValueError("reference_stencil is 1-D only")
        mesh, d = self.mesh, self.d
        N = mesh.N[d]
        vel = _host(vel)
        phi = _host(phi)
        v = float(vel[i])
        pos = v > 0.0
        c = mesh.centers(d)
        f = mesh.faces[d]

        if not self.periodic and (
            (pos and i == 0) or (not pos and i == N)
        ):
            # ghost-cell average, folded per the BC with npts = 2
            # (TVD term: deriv 0, accu 2; secondordertvd.c:233-249 +
            # fdutils.c:330-460)
            side = 0 if i == 0 else 1
            bc = self.bcs[2 * d + side]
            xb = f[0] if side == 0 else f[N]
            i_in = 0 if side == 0 else N - 1
            xg = (2 * xb - c[i_in])  # mirrored ghost center
            entries = {("pt", i_in): 0.5}
            w = 0.5  # ghost coefficient
            if bc.type == FDBCType.DIRICHLET:
                # linear through (xb, bc), (c_in, phi_in) at xg
                a0 = (xg - c[i_in]) / (xb - c[i_in])
                a1 = (xg - xb) / (c[i_in] - xb)
                entries[("bc", side)] = w * a0
                entries[("pt", i_in)] += w * a1
            elif bc.type == FDBCType.NEUMANN:
                # p'(xb) FD over (xg, c_in); solve for the ghost
                a_off = 1.0 / (xg - c[i_in])
                a1 = 1.0 / (c[i_in] - xg)
                entries[("bc", side)] = w / a_off
                entries[("pt", i_in)] += -w * a1 / a_off
            else:  # NONE: extrapolate ghost from 2 nearest cells
                i2 = 1 if side == 0 else N - 2
                a0 = (xg - c[i2]) / (c[i_in] - c[i2])
                a2 = (xg - c[i_in]) / (c[i2] - c[i_in])
                entries[("pt", i_in)] += w * a0
                entries[("pt", i2)] = entries.get(("pt", i2), 0.0) \
                    + w * a2
            out = []
            for k, val in entries.items():
                if val != 0.0:
                    out.append((k[0], k[1], val))
            return out

        # interior formula (+ the outflow-boundary quirk: off-grid
        # downwind phi reads as 0)
        u = i - 1 if pos else i
        dn = i if pos else i - 1
        fu = i - 1 if pos else i + 1
        grad = self.grad.apply(torch.from_numpy(phi)).numpy()
        nf = mesh.nfaces(d)
        g_fu = float(grad[fu % nf]) if self.periodic else (
            float(grad[fu]) if 0 <= fu < nf else 0.0
        )
        g_fc = float(grad[i])
        r = g_fu / g_fc if abs(g_fc) > 1e-30 else 1.0
        psi = float(self.limiter(torch.tensor(r, dtype=torch.float64)))
        alpha = (self.alpha_plus if pos else self.alpha_minus)[i]

        def phival(j):
            if self.periodic:
                return float(phi[j % N])
            return float(phi[j]) if 0 <= j < N else 0.0

        const = float(alpha) * psi * (phival(dn) - phival(u))
        out = [("pt", u % N if self.periodic else u, 1.0)]
        if const != 0.0:
            out.append(("const", None, const))
        return out

    __call__ = apply
