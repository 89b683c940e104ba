"""Geometric multigrid for the 2-D and 3-D pressure-Poisson operator.

Counterpart of fluca_tpu.solvers.mg. The Schur-complement solve
S p' = rhs with S = -D Gst (the fractional-step limit, reference
THEORY_GUIDE.md:330-341) is preconditioned by cell-centered geometric
multigrid with volume-weighted 2:1 coarsening, damped-Jacobi (or
Chebyshev) smoothing, and an exact coarse solve by a host-precomputed
pseudo-inverse.

Symmetry: on non-uniform grids D*Gst is symmetric only in the
cell-volume inner product, so the volume-scaled system
  Shat p = vol .* (-D Gst p),  rhs_hat = cellvol .* rhs
is solved; it is symmetric positive semidefinite in the Euclidean inner
product (pure-Neumann pressure problems keep the constant nullspace,
handled by mean projection in CG and the pseudo-inverse on the coarse
level).

Every level's apply, residual and Jacobi sweep goes through the fused
Poisson 2-D or 3-D kernel (ops/cuda_stencil.py), by the mesh's
dimension, whatever the level's size. Under a device grid
(``set_device_grid``) each level the grid splits evenly runs it sharded,
one halo launch per shard (parallel/sharded.py).

Under a rank-held grid (``grid=``, a ``parallel.mesh.RankGrid``) the
finest level, and each coarser one the grid splits evenly, hold this
rank's block (``held`` levels): their fields, volumes and kernel
coefficients are the block's, their kernel the halo instance with edge
planes from the neighbour ranks. Restriction and prolongation between
two held levels stay inside a block (2:1 sums and piecewise-constant
copies reach no cell past it). At the first level the grid does not
split, or the coarsest, the residual is gathered to every rank
(``RankGrid.gather``), which then solves that level and every one below
it as one process does, with the same coarse pseudo-inverse built from
the host-f64 tables; the correction comes back as this rank's block.

A hierarchy in bfloat16 (the reduced-precision ABF preconditioner's
Schur solve) keeps its fields, volumes, inverse diagonals, restriction,
prolongation and V-cycle in bf16 and its kernel coefficient arrays in
float32 (``cuda_stencil.coef_dtype``). Its coarse pseudo-inverse is
stored rounded to bf16, as the reference stores it, and applied with
float32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.ops.banded import compose_axis_stencils
from fluca_tpu_torch.utils.profiling import span


@dataclass
class _Level:
    mesh: CartMesh
    # the Shat kernel's arrays (Poisson2DCoeffs or Poisson3DCoeffs)
    coeffs: cuda_stencil.Poisson2DCoeffs | cuda_stencil.Poisson3DCoeffs
    vol: torch.Tensor  # scale * cell volumes (operator row weights)
    cellvol: torch.Tensor  # plain cell volumes (rhs symmetrization)
    inv_diag: torch.Tensor  # 1 / diag(Shat)
    host_dgst: tuple  # per-axis host-f64 D@Gst AxisStencils
    host_vol: np.ndarray  # scale * cell volumes, host f64, of the whole level
    cheb_lmax: float | None = None  # Chebyshev smoothing upper bound
    # under a device grid: the level's sharded kernel by mode
    # (parallel/sharded.py), or None for the unsharded kernel
    sharded: dict | None = None
    # under a rank-held grid: this rank's block of the level (its fields,
    # volumes and coefficients are the block's), or None for the whole
    block: object = None

    @property
    def shape(self) -> tuple:
        """The shape of the level's fields here: its block's, or its own."""
        return self.mesh.cell_shape if self.block is None else self.block.cell_shape


# the axis along which each of the kernel's coefficient arrays runs
# (poisson2d_coeffs: RX, RY, CY, CYb; poisson3d_coeffs: A0, C1, C2, H0-H2)
_COEFF_AXES = {2: (0, 0, 1, 1), 3: (0, 1, 2, 0, 1, 2)}


def _build_level(mesh: CartMesh, axbcs, scale: float, dtype, device,
                 block=None) -> _Level:
    """One level; with ``block`` (a ``parallel.mesh.Block``), that block's
    rows of the host-f64 tables."""
    dim = mesh.dim
    host_dgst = []
    diag = np.zeros(mesh.cell_shape)
    for d in range(dim):
        gst, _, _ = T_.gst_tables(mesh, d, axbcs[d])
        div = T_.div_tables(mesh, d)
        dgst = compose_axis_stencils(div, gst)
        host_dgst.append(dgst)
        w0 = dgst.as_dict().get(0, np.zeros(mesh.N[d]))
        shape = [1] * dim
        shape[d] = -1
        diag = diag + (-w0).reshape(shape)

    vol = mesh.cell_volumes()
    host_vol = scale * vol
    inv_diag = 1.0 / np.where(diag == 0.0, 1.0, scale * vol * diag)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if dim == 2:
        make, cls = cuda_stencil.poisson2d_coeffs, cuda_stencil.Poisson2DCoeffs
    else:
        make, cls = cuda_stencil.poisson3d_coeffs, cuda_stencil.Poisson3DCoeffs
    def cut(a):
        return a if block is None else np.ascontiguousarray(block.cut(a))

    arrays = make(mesh, host_dgst, host_vol)
    if block is not None:
        arrays = [a[..., block.cells(ax)] for a, ax in zip(arrays, _COEFF_AXES[dim])]
    coeffs = cls.from_host(arrays, mesh.periodic, cuda_stencil.coef_dtype(dtype), device)
    return _Level(
        mesh=mesh,
        coeffs=coeffs,
        vol=dev(cut(host_vol)),
        cellvol=dev(cut(vol)),
        inv_diag=dev(cut(inv_diag)),
        host_dgst=tuple(host_dgst),
        host_vol=host_vol,
        block=block,
    )


def _coarsen_mesh(mesh: CartMesh) -> CartMesh | None:
    if any(n % 2 != 0 or n < 4 for n in mesh.N):
        return None
    cm = CartMesh(N=tuple(n // 2 for n in mesh.N), periodic=mesh.periodic)
    cm.set_coordinates(*[f[::2] for f in mesh.faces])
    return cm


class PoissonMG:
    """V-cycle preconditioner for Shat = vol .* (-D Gst) * scale."""

    def __init__(
        self,
        mesh: CartMesh,
        bcs,
        *,
        scale: float,
        dtype,
        device,
        nu_pre: int = 2,
        nu_post: int = 2,
        omega: float = 0.8,
        max_levels: int = 16,
        coarse_size: int = 1024,
        smoother: str = "jacobi",  # jacobi | chebyshev
        grid=None,
    ):
        if mesh.dim not in (2, 3):
            raise ValueError(f"PoissonMG takes 2-D or 3-D meshes, not "
                             f"{mesh.dim}-D")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        device = torch.device(device)
        axbcs = T_.axis_bcs(mesh, bcs)
        self.nu_pre, self.nu_post, self.omega = nu_pre, nu_post, omega
        self.smoother = smoother
        self._kernel = (cuda_stencil.poisson2d if mesh.dim == 2
                        else cuda_stencil.poisson3d)
        # the shapes of the levels that run sharded (set_device_grid, or
        # the held levels of a rank-held grid)
        self.sharded_levels: tuple = ()
        meshes = [mesh]
        while len(meshes) < max_levels and int(np.prod(meshes[-1].N)) > coarse_size:
            mc = _coarsen_mesh(meshes[-1])
            if mc is None:
                break
            meshes.append(mc)
        # under a rank-held grid: the finest level, then each the grid
        # splits evenly above the coarsest, hold this rank's block
        self.grid = grid
        self.nheld = 0
        if grid is not None:
            self.nheld = 1
            while self.nheld < len(meshes) - 1 and grid.divides(meshes[self.nheld].N):
                self.nheld += 1
        self.levels: list[_Level] = [
            _build_level(m, axbcs, scale, dtype, device,
                         grid.block(m.N, m.periodic) if li < self.nheld else None)
            for li, m in enumerate(meshes)]
        if grid is not None:
            self.sharded_levels = tuple(m.N for m in meshes[:self.nheld])
            for lvl in self.levels[:self.nheld]:
                lvl.sharded = self._held_kernels(grid, lvl)

        # Chebyshev smoothing bounds: lambda_max of the
        # Jacobi-preconditioned operator per level via power iteration
        # (setup time); smooth on [lmax/4, 1.05*lmax]
        if smoother == "chebyshev":
            rng = np.random.default_rng(12345)
            for lvl in self.levels:
                x = rng.standard_normal(lvl.mesh.cell_shape)
                if lvl.block is not None:
                    x = np.ascontiguousarray(lvl.block.cut(x))
                x = torch.as_tensor(x, dtype=dtype, device=device)
                lmax = 2.0
                for _ in range(12):
                    y = lvl.inv_diag * self._apply_level(lvl, x)
                    nrm = float(self._norm(lvl, y))
                    if nrm == 0.0:
                        break
                    lmax = nrm / max(float(self._norm(lvl, x)), 1e-300)
                    x = y / nrm
                lvl.cheb_lmax = 1.05 * lmax

        # coarse-level exact solve via dense pseudo-inverse, assembled
        # on the host in float64 from the banded tables (Kronecker sums).
        # Probing the device apply in f32 instead leaves the constant
        # nullspace's singular value at ~1e-7, which survives pinv's
        # cutoff and puts O(1e7) entries in the inverse.
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
        self._coarse_pinv = torch.as_tensor(
            np.linalg.pinv(A), dtype=dtype, device=device
        )
        # the coarse product sums in at least float32: for a bf16
        # hierarchy, the bf16-rounded pinv widened once
        self._coarse_pinv_acc = self._coarse_pinv.to(
            torch.promote_types(dtype, torch.float32)
        )
        if device.type == "cuda":
            # the coarse mat-vec must run in full f32, never TF32
            torch.backends.cuda.matmul.allow_tf32 = False

    def _norm(self, lvl, x):
        """||x|| over the level (added over the ranks on a held level)."""
        if lvl.block is None:
            return torch.linalg.vector_norm(x)
        return torch.sqrt(self.grid.allsum(torch.sum(x * x)))

    def _held_kernels(self, grid, lvl):
        from fluca_tpu_torch.parallel.sharded import build_poisson_sharded

        return {mode: build_poisson_sharded(grid, lvl, mode, self.omega)
                for mode in cuda_stencil.POISSON_MODES}

    # ------------------------------------------------------------------
    def set_device_grid(self, grid) -> None:
        """Run each level that ``grid`` splits evenly through the sharded
        Poisson kernel (parallel/sharded.py): a neighbour exchange and one
        halo launch per shard. The other levels keep the unsharded kernel
        on the global tensor, the counterpart of the reference's GSPMD
        fallback (fluca_tpu/solvers/mg.py:229-290). The reference's size
        gate (prod(N) < 256*256 stays unsharded) is a TPU tuning choice and
        is not carried over. ``grid=None``, or a degenerate grid of one
        shard, restores the unsharded kernels. ``sharded_levels`` lists
        the shapes of the levels that run sharded."""
        if self.grid is not None:
            raise ValueError("a hierarchy built on a rank-held grid holds its blocks: "
                             "build another for another grid")
        for lvl in self.levels:
            lvl.sharded = None
            if grid is not None and grid.size > 1 and grid.divides(lvl.mesh.N):
                lvl.sharded = self._held_kernels(grid, lvl)
        self.sharded_levels = tuple(lvl.mesh.N for lvl in self.levels if lvl.sharded)

    def _poisson(self, lvl: _Level, mode, p, b=None, w=None):
        """The level's Poisson kernel in ``mode`` (the smoother's omega)."""
        if lvl.sharded is not None:
            return lvl.sharded[mode](p, b, w)
        return self._kernel(mode, p, lvl.coeffs, b, w, self.omega)

    def _apply_level(self, lvl: _Level, p):
        """Shat p on one level."""
        return self._poisson(lvl, "apply", p)

    def apply_op(self, p):
        """Top-level operator Shat (for CG)."""
        return self._apply_level(self.levels[0], p)

    def scale_rhs(self, r):
        """Symmetrize the rhs to match Shat: Shat p = cellvol * r
        solves (-scale * D Gst) p = r. (cellvol, not vol = scale *
        cellvol: the scale acts on the operator side only, otherwise it
        cancels and the solve returns p off by 1/scale.)"""
        return self.levels[0].cellvol * r

    # ------------------------------------------------------------------
    def _smooth(self, lvl, x, b, n):
        if self.smoother == "chebyshev":
            return self._smooth_cheby(lvl, x, b, n)
        for _ in range(n):
            x = self._poisson(lvl, "smooth", x, b, lvl.inv_diag)
        return x

    def _residual(self, lvl, x, b):
        return self._poisson(lvl, "residual", x, b)

    def _smooth_cheby(self, lvl, x, b, n):
        """Chebyshev(n) smoothing on [lmax/4, lmax] of the
        Jacobi-preconditioned operator (three-term recurrence)."""
        lmax = lvl.cheb_lmax
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = self._residual(lvl, x, b)
        z = lvl.inv_diag * r
        d = z / theta
        x = x + d
        for _ in range(1, n):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = self._residual(lvl, x, b)
            z = lvl.inv_diag * r
            d = rho_new * rho * d + 2.0 * rho_new / delta * z
            rho = rho_new
            x = x + d
        return x

    @staticmethod
    def _restrict(r):
        """Sum 2x2 fine cells into each coarse cell (adjoint of
        piecewise-constant prolongation; residuals are vol-weighted so
        plain summation is the conservative restriction)."""
        for d in range(r.dim()):
            shape = r.shape
            new = shape[:d] + (shape[d] // 2, 2) + shape[d + 1:]
            r = r.reshape(new).sum(dim=d + 1)
        return r

    @staticmethod
    def _prolong(e):
        for d in range(e.dim()):
            e = torch.repeat_interleave(e, 2, dim=d)
        return e

    def _gather(self, lvl, x):
        """The level's global field from every rank's block ``x``."""
        return self.grid.gather(x, lvl.mesh.N, lvl.mesh.periodic)

    def _coarse_solve(self, lvl, b):
        with span("mg.coarse"):
            held = lvl.block is not None
            if held:
                b = self._gather(lvl, b)
            pinv = self._coarse_pinv_acc
            xf = torch.matmul(pinv, b.reshape(-1).to(pinv.dtype))
            x = xf.to(b.dtype).reshape(lvl.mesh.cell_shape)
            return lvl.block.cut(x).contiguous() if held else x

    def _vcycle(self, li, x, b):
        lvl = self.levels[li]
        if li == len(self.levels) - 1:
            return self._coarse_solve(lvl, b)
        x = self._smooth(lvl, x, b, self.nu_pre)
        r = self._residual(lvl, x, b)
        coarse = self.levels[li + 1]
        if lvl.block is None or coarse.block is not None:
            # both levels whole, or both held: the transfer stays in a block
            rc = self._restrict(r)
            ec = self._vcycle(li + 1, torch.zeros_like(rc), rc)
            x = x + self._prolong(ec)
        elif self.grid.divides(coarse.mesh.N):
            # the last held level: restrict each block, gather the coarse
            # level, and take this rank's block of its correction
            rc = self._gather(coarse, self._restrict(r))
            ec = self._vcycle(li + 1, torch.zeros_like(rc), rc)
            blk = self.grid.block(coarse.mesh.N, coarse.mesh.periodic)
            x = x + self._prolong(blk.cut(ec))
        else:
            # a block of odd extent: gather the fine residual
            rc = self._restrict(self._gather(lvl, r))
            ec = self._vcycle(li + 1, torch.zeros_like(rc), rc)
            x = x + lvl.block.cut(self._prolong(ec))
        x = self._smooth(lvl, x, b, self.nu_post)
        return x

    def precondition(self, r):
        """One V-cycle as preconditioner: approximately Shat^{-1} r (the
        span ``mg.vcycle``, its coarsest solve ``mg.coarse``)."""
        with span("mg.vcycle"):
            return self._vcycle(0, torch.zeros_like(r), r)
