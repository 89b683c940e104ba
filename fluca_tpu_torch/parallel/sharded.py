"""The stencil kernels on the shards of a device grid.

Counterpart of fluca_tpu.parallel.pallas_sharded, which restores the
reference's decomposition-invariant hot path (the same assembly sweeps
on 1 and N ranks, fluca/src/ns/impl/linearcn/cnlinearcart2d.c:618-622,
with DMStag halo scatters, fluca/src/mesh/impl/cart/cart.c:88-104) for
the TPU kernels: each shard runs the same kernel on its block, with the
values that cross a shard boundary supplied by a neighbour exchange.

Here each ``build_*`` function validates the decomposition, and each
call exchanges the edge planes (``parallel.halo.neighbor_slabs``) and
launches the halo kernel (``ops/cuda_stencil.py`` ``*_halo``):
- on a ``DeviceGrid``, once per shard on that shard's box of the global
  tensors;
- on a ``RankGrid``, once on this rank's block at offset 0
  (``HaloLayout.rank_block``), with its rows of the coefficients and the
  edge planes received from the neighbour ranks.
The kernels do the unsharded kernels' arithmetic in the same order, so a
sharded call matches the unsharded kernel bit for bit. A ``build_*``
function raises ValueError where the grid does not split the mesh evenly
or a block misses a kernel's constraint; ``PoissonMG`` keeps the
unsharded kernel on the levels the grid does not split.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.parallel.halo import neighbor_slabs, rank_slabs
from fluca_tpu_torch.parallel.mesh import RankGrid


def halo_layout(grid, mesh) -> cuda_stencil.HaloLayout:
    """The kernels' view of ``grid`` over ``mesh``: the shards' boxes of a
    ``DeviceGrid``, or this rank's block of a ``RankGrid``; raises
    ValueError where the grid does not split the mesh evenly."""
    if isinstance(grid, RankGrid):
        blk = grid.block(mesh.N, mesh.periodic)
        return cuda_stencil.HaloLayout.rank_block(grid.device, blk.cell_shape,
                                                  mesh.periodic, blk.split)
    return cuda_stencil.HaloLayout(grid, tuple(mesh.N), tuple(mesh.periodic))


def field_edges(layout: cuda_stencil.HaloLayout, x, grid=None):
    """The edge planes of ``x`` on each halo axis (None on the others):
    from the neighbour ranks where ``grid`` is a ``RankGrid`` (``layout``
    its ``halo_layout``), else from the shards of ``layout.grid``."""
    if not layout.halo_axes:
        return (None,) * len(layout.shape)
    if isinstance(grid, RankGrid):
        return tuple(rank_slabs(x, grid, a, layout.periodic[a])
                     if a in layout.halo_axes else None for a in range(len(layout.shape)))
    return tuple(neighbor_slabs(x, layout.grid, a, layout.periodic[a])
                 if a in layout.halo_axes else None for a in range(len(layout.shape)))


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the sharded kernels have float32 and float64 instances, "
                         f"not {dtype}")


class ShardedPoisson:
    """One multigrid level's Poisson kernel in one mode under a device
    grid: f(p) (apply), f(p, b) (residual), f(p, b, w) (smooth)."""

    def __init__(self, grid, level, mode: str, omega: float):
        if mode not in cuda_stencil.POISSON_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        _check_dtype(level.vol.dtype)
        self.grid = grid
        self.layout = halo_layout(grid, level.mesh)
        self.kernel = (cuda_stencil.poisson2d_halo if level.mesh.dim == 2
                       else cuda_stencil.poisson3d_halo)
        self.call = self.kernel.prepare(mode, level.coeffs, self.layout, omega)

    def edges(self, p):
        return field_edges(self.layout, p, self.grid)

    def __call__(self, p, b=None, w=None):
        return self.kernel.run(self.call, p, self.edges(p), b, w)

    def launch(self, p, edges, b=None, w=None):
        """The kernels on edge planes ``edges`` of p (``field_edges``)."""
        return self.kernel.run(self.call, p, edges, b, w)


def build_poisson_sharded(grid, level, mode: str = "apply",
                          omega: float = 0.8) -> ShardedPoisson:
    """The sharded fused Poisson kernel for one multigrid level
    (pallas_sharded.py:71): f(p[, b][, w]) with halo edges from
    ``neighbor_slabs``; on a ``RankGrid`` the level's fields and
    coefficients are this rank's block. Raises ValueError where the level
    does not decompose evenly over the grid."""
    return ShardedPoisson(grid, level, mode, omega)


class ShardedMomentum2D:
    """The 2-D momentum A-apply under a device grid: f(W, u, v)."""

    def __init__(self, grid, mesh, dtype):
        if mesh.dim != 2:
            raise ValueError("build_momentum2d_sharded takes a 2-D mesh")
        _check_dtype(dtype)
        self.dtype = dtype
        self.grid = grid
        self.layout = halo_layout(grid, mesh)
        cuda_stencil.check_momentum_local("the sharded momentum apply", self.layout)

    def edges(self, x):
        return field_edges(self.layout, x, self.grid)

    def __call__(self, W, u, v):
        u, v = u.to(self.dtype), v.to(self.dtype)
        return self.launch(W, u, v, self.edges(u), self.edges(v))

    def launch(self, W, u, v, u_edges, v_edges):
        return cuda_stencil.momentum2d_halo(W, u, v, self.layout, u_edges, v_edges)


def build_momentum2d_sharded(grid, mesh, dtype) -> ShardedMomentum2D:
    """The sharded fused 2-D momentum A-apply (pallas_sharded.py:181):
    f(W, u, v) on the (26, N0, N1) plane stack (on a ``RankGrid``, this
    rank's block of it), with u's and v's edge planes on every split
    axis. Raises ValueError where the grid does
    not decompose the mesh evenly or a block is narrower than 3 on a
    split axis."""
    return ShardedMomentum2D(grid, mesh, dtype)


@functools.lru_cache(maxsize=None)
def _face_index(nfaces: int, n: int, nshards: int, device: torch.device):
    """Faces (k + 1) n, k < nshards, of an axis of ``nfaces`` faces (face
    N wraps to 0 on a periodic axis, which has N faces)."""
    return torch.tensor([((k + 1) * n) % nfaces for k in range(nshards)], device=device)


@dataclass(frozen=True)
class ShardedFactors:
    """The step's face factors for the sharded 3-D A-apply: the factors
    (global, or a rank's block), and per halo axis a the hi face planes of
    U0[a] and v0f[a][0..2] (None on the other axes)."""

    factors: cuda_stencil.Momentum3DFactors
    face_hi: tuple


class ShardedMomentum3D:
    """The 3-D momentum A-apply under a device grid: ``prep(U0, v0f)``
    once per step, then ``apply(v, prepped)``. On a ``RankGrid`` the bands
    are this rank's rows, the fields and face arrays its block (lo +
    hilast faces)."""

    def __init__(self, grid, mesh, axbcs, rho, mu, dt, dtype):
        if mesh.dim != 3:
            raise ValueError("build_momentum_sharded takes a 3-D mesh")
        _check_dtype(dtype)
        self.grid = grid
        self.layout = halo_layout(grid, mesh)
        cuda_stencil.check_momentum_local("the sharded momentum apply", self.layout)
        host = cuda_stencil.build_momentum_bands_3d(mesh, axbcs, rho, mu, dt)
        self.block = None
        if isinstance(grid, RankGrid):
            self.block = grid.block(mesh.N, mesh.periodic)
            host = [B[:, self.block.cells(a)] for a, B in enumerate(host)]
        self.bands = cuda_stencil.Momentum3DBands.from_host(host, mesh.periodic, dtype,
                                                            grid.device)
        cuda_stencil.check_far_reads("build_momentum_sharded", self.layout, [
            (a, off, self.bands.b[a][cuda_stencil.mom3d_lap_row(c, off)], 0)
            for a in range(3) for c in range(3) for off in (-2, 2)])

    def face_planes(self, F, a):
        """The hi face plane of each shard along ``a`` of face array ``F``
        of axis ``a``: face (k + 1) n_a, which is the high neighbour's
        face 0, global face N at a wall, or face 0 on a periodic axis. On
        a ``RankGrid``: this rank's face n (face N, which it owns, at the
        high end of a wall axis), else the high neighbour's face 0,
        received from it."""
        if self.block is None:
            return F.index_select(a, _face_index(F.shape[a], self.layout.local[a],
                                                 self.layout.grid.shape[a], F.device))
        # every rank along the axis takes part in the exchange
        hi = rank_slabs(F, self.grid, a, self.layout.periodic[a], 0, 1)[1]
        n = self.block.n[a]
        return F.narrow(a, n, 1).contiguous() if F.shape[a] > n else hi

    def prep(self, U0, v0f) -> ShardedFactors:
        nfaces = None if self.block is None else tuple(
            self.block.nfaces(a) for a in range(3))
        f = cuda_stencil.Momentum3DFactors.from_faces(U0, v0f, self.bands, nfaces=nfaces)
        face_hi = tuple(
            tuple(self.face_planes(F, a) for F in (f.U0[a], *f.v0f[a]))
            if a in self.layout.halo_axes else None for a in range(3))
        return ShardedFactors(f, face_hi)

    def edges(self, x):
        return field_edges(self.layout, x, self.grid)

    def apply(self, v, prepped: ShardedFactors):
        v = tuple(x.to(self.bands.b[0].dtype) for x in v)
        return self.launch(v, prepped, tuple(self.edges(x) for x in v))

    def launch(self, v, prepped: ShardedFactors, v_edges):
        return cuda_stencil.momentum3d_halo(self.bands, prepped.factors, v, self.layout,
                                            v_edges, prepped.face_hi)


def build_momentum_sharded(grid, mesh, axbcs, rho, mu, dt,
                           dtype) -> ShardedMomentum3D:
    """The sharded fused 3-D momentum A-apply (pallas_sharded.py:256):
    ``prep`` takes the step's (U0, v0f) to the global factors plus the hi
    face planes of each split axis (the reference's lo slices and global
    hi planes, ``prep`` :295-322), ``apply`` takes v with its edge planes
    on every split axis. Raises ValueError where the grid does not
    decompose the mesh evenly or a block is narrower than 3 on a split
    axis."""
    return ShardedMomentum3D(grid, mesh, axbcs, rho, mu, dt, dtype)
