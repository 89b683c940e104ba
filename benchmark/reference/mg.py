"""Geometric multigrid V-cycle of the plain reference: a frozen copy of
the port's ``solvers/mg.py`` on one whole grid, with every level's
Poisson apply, residual and damped-Jacobi sweep written as banded sums
(``apply_axis_stencil`` over the composed per-axis D@Gst stencils)
rather than through a kernel or its packed coefficient arrays.

The operator is the volume-scaled Shat p = vol .* (-D Gst p) with vol =
scale * cell volumes; 2:1 volume-weighted restriction (a sum over the
fine cells), piecewise-constant prolongation, and an exact coarse solve
by a host float64 pseudo-inverse. A hierarchy in bfloat16 computes in
float32 and rounds each level operation's result to bf16, keeps its
fields, volumes and inverse diagonals in bf16, and applies the coarse
pseudo-inverse rounded to bf16 with float32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import tables as T_
from .banded import apply_axis_stencil, compose_axis_stencils
from .mesh import CartMesh


def acc_dtype(dtype):
    """The arithmetic dtype for fields of ``dtype``: float32 for fields
    narrower than 32 bits, else the field dtype."""
    return torch.float32 if dtype.itemsize < 4 else dtype


@dataclass
class _Level:
    mesh: CartMesh
    dgst: tuple  # per-axis device bands of D@Gst, in the arithmetic dtype
    vol_acc: torch.Tensor  # scale * cell volumes, arithmetic dtype
    vol: torch.Tensor  # scale * cell volumes, field dtype
    cellvol: torch.Tensor  # plain cell volumes, field dtype
    inv_diag: torch.Tensor  # 1 / diag(Shat), field dtype
    host_dgst: tuple
    host_vol: np.ndarray


def _build_level(mesh, axbcs, scale, dtype, device) -> _Level:
    dim = mesh.dim
    host_dgst = []
    diag = np.zeros(mesh.cell_shape)
    for d in range(dim):
        gst, _, _ = T_.gst_tables(mesh, d, axbcs[d])
        dgst = compose_axis_stencils(T_.div_tables(mesh, d), gst)
        host_dgst.append(dgst)
        w0 = dgst.as_dict().get(0, np.zeros(mesh.N[d]))
        shape = [1] * dim
        shape[d] = -1
        diag = diag + (-w0).reshape(shape)
    vol = mesh.cell_volumes()
    host_vol = scale * vol
    inv_diag = 1.0 / np.where(diag == 0.0, 1.0, scale * vol * diag)
    acc = acc_dtype(dtype)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return _Level(mesh=mesh,
                  dgst=tuple(st.device_bands(dim, acc, device) for st in host_dgst),
                  vol_acc=dev(host_vol, acc), vol=dev(host_vol), cellvol=dev(vol),
                  inv_diag=dev(inv_diag), host_dgst=tuple(host_dgst), host_vol=host_vol)


def _coarsen_mesh(mesh: CartMesh):
    if any(n % 2 != 0 or n < 4 for n in mesh.N):
        return None
    cm = CartMesh(N=tuple(n // 2 for n in mesh.N), periodic=mesh.periodic)
    cm.set_coordinates(*[f[::2] for f in mesh.faces])
    return cm


class PoissonMG:
    """V-cycle preconditioner for Shat = vol .* (-D Gst) * scale."""

    def __init__(self, mesh: CartMesh, bcs, *, scale, dtype, device, nu_pre=2, nu_post=2,
                 omega=0.8, max_levels=16, coarse_size=1024):
        device = torch.device(device)
        axbcs = T_.axis_bcs(mesh, bcs)
        self.nu_pre, self.nu_post, self.omega = nu_pre, nu_post, omega
        self.dtype = dtype
        meshes = [mesh]
        while len(meshes) < max_levels and int(np.prod(meshes[-1].N)) > coarse_size:
            mc = _coarsen_mesh(meshes[-1])
            if mc is None:
                break
            meshes.append(mc)
        self.levels = [_build_level(m, axbcs, scale, dtype, device) for m in meshes]
        coarse = self.levels[-1]
        Nc = coarse.mesh.N
        n = int(np.prod(Nc))
        A = np.zeros((n, n))
        for d, st in enumerate(coarse.host_dgst):
            Dd = st.to_dense(Nc[d])
            left = int(np.prod(Nc[:d], initial=1))
            right = int(np.prod(Nc[d + 1:], initial=1))
            A += np.kron(np.kron(np.eye(left), Dd), np.eye(right))
        A = -coarse.host_vol.ravel()[:, None] * A
        pinv = torch.as_tensor(np.linalg.pinv(A), dtype=dtype, device=device)
        self._coarse_pinv = pinv.to(torch.promote_types(dtype, torch.float32))

    def _op(self, lvl, mode, p, b=None):
        """Shat p | b - Shat p | p + omega inv_diag (b - Shat p), computed
        in the arithmetic dtype and returned in the fields'."""
        acc = acc_dtype(p.dtype)
        pa = p.to(acc)
        s = None
        for d in range(lvl.mesh.dim):
            t = apply_axis_stencil(lvl.dgst[d], pa, d, lvl.mesh.N[d], lvl.mesh.periodic[d])
            s = t if s is None else s + t
        sp = -lvl.vol_acc * s
        if mode == "apply":
            out = sp
        elif mode == "residual":
            out = b.to(acc) - sp
        else:
            out = pa + self.omega * lvl.inv_diag.to(acc) * (b.to(acc) - sp)
        return out.to(p.dtype)

    def apply_op(self, p):
        return self._op(self.levels[0], "apply", p)

    def scale_rhs(self, r):
        return self.levels[0].cellvol * r

    def _residual(self, lvl, x, b):
        return self._op(lvl, "residual", x, b)

    @staticmethod
    def _restrict(r):
        for d in range(r.dim()):
            shape = r.shape
            r = r.reshape(shape[:d] + (shape[d] // 2, 2) + shape[d + 1:]).sum(dim=d + 1)
        return r

    @staticmethod
    def _prolong(e):
        for d in range(e.dim()):
            e = torch.repeat_interleave(e, 2, dim=d)
        return e

    def _vcycle(self, li, x, b):
        lvl = self.levels[li]
        if li == len(self.levels) - 1:
            xf = torch.matmul(self._coarse_pinv, b.reshape(-1).to(self._coarse_pinv.dtype))
            return xf.to(b.dtype).reshape(lvl.mesh.cell_shape)
        for _ in range(self.nu_pre):
            x = self._op(lvl, "smooth", x, b)
        r = self._residual(lvl, x, b)
        rc = self._restrict(r)
        ec = self._vcycle(li + 1, torch.zeros_like(rc), rc)
        x = x + self._prolong(ec)
        for _ in range(self.nu_post):
            x = self._op(lvl, "smooth", x, b)
        return x

    def precondition(self, r):
        return self._vcycle(0, torch.zeros_like(r), r)
