"""Explicit neighbour exchange between the shards of a device grid.

Counterpart of fluca_tpu.parallel.halo and of
``fluca_tpu.parallel.pallas_sharded._neighbor_slabs`` (the reference's
DMGlobalToLocal ghost scatters, fluca/src/mesh/impl/cart/cart.c:88-104),
which exchange boundary slabs with ``lax.ppermute`` inside ``shard_map``.
Here the shards of a grid are boxes of one global tensor on one device
(``parallel/mesh.py``): an exchange gathers, for every shard at once, the
planes that lie just past its block, with one ``index_select`` per axis.

Conventions as in the reference: fields are split block-wise along the
grid axes; a periodic axis wraps around the whole grid; a non-periodic
global boundary receives zeros (the boundary-folded coefficients are
zero there). With one shard on an axis this degenerates to the wrap
(periodic) or zeros: the unsharded kernels' own edge convention.

``stencil_apply_sharded_overlapped`` (halo.py:122 there) overlaps the
sends with compute; on one device there is nothing to overlap. It waits
for the multi-process transport (ROADMAP queue 1, item 1).
"""

from __future__ import annotations

import functools

import torch

from fluca_tpu_torch.parallel.mesh import DeviceGrid


@functools.lru_cache(maxsize=None)
def _slab_index(N: int, nshards: int, width: int, device: torch.device):
    """Indices along an axis of N cells split into ``nshards`` blocks:
    for each block the ``width`` planes below it, then for each the
    ``width`` planes above it, wrapped around the axis."""
    n = N // nshards
    lo = [(k * n - width + i) % N for k in range(nshards) for i in range(width)]
    hi = [((k + 1) * n + i) % N for k in range(nshards) for i in range(width)]
    return torch.tensor(lo + hi, device=device)


def neighbor_slabs(x, grid: DeviceGrid, axis: int, periodic: bool, width: int = 1):
    """(lo, hi): for each shard along ``axis``, the ``width`` planes of its
    low neighbour just below its block and those of its high neighbour
    just above it. Each has ``x``'s shape with ``grid.shape[axis] *
    width`` planes along ``axis``, shard k's at k * width ..; zeros past a
    non-periodic global boundary, the other end of the grid on a
    periodic axis. Counterpart of ``pallas_sharded._neighbor_slabs``."""
    N, s = x.shape[axis], grid.shape[axis]
    if N % s or N // s < width:
        raise ValueError(f"axis {axis} of {N} cells does not split into {s} "
                         f"blocks of at least {width}")
    both = x.index_select(axis, _slab_index(N, s, width, x.device))
    if not periodic:
        both.narrow(axis, 0, width).zero_()
        both.narrow(axis, 2 * s * width - width, width).zero_()
    return both.split(s * width, axis)


def _blocks(x, axis, nshards):
    """``x`` with ``axis`` split into (nshards, block)."""
    return x.unflatten(axis, (nshards, x.shape[axis] // nshards))


def halo_exchange(grid: DeviceGrid, x, periodic, width: int = 1):
    """Every shard's block extended by ``width`` ghost cells on each side of
    every grid axis, filled from its neighbours (zeros past a non-periodic
    boundary), laid out as the reference lays them out: the blocks side
    by side, (N_a + 2 * width * shards_a) along each axis. The axes are
    exchanged in turn, each on the result of the last, so the corners
    come from the diagonal neighbours, as in the reference."""
    for a in range(grid.dim):
        s = grid.shape[a]
        lo, hi = neighbor_slabs(x, grid, a, periodic[a], width)
        x = torch.cat([_blocks(lo, a, s), _blocks(x, a, s), _blocks(hi, a, s)],
                      a + 1).flatten(a, a + 1)
    return x


def stencil_apply_sharded(grid: DeviceGrid, bands_per_axis, x, periodic):
    """Banded stencil apply with an explicit halo exchange: each shard
    takes one ghost layer per axis from its neighbours, then applies the
    tridiagonal per-axis bands on its block; the result is the global
    field. ``bands_per_axis[d]`` is {offset in (-1, 0, 1): 1-D global
    coefficient array of length N_d}. Counterpart of
    ``fluca_tpu.parallel.halo.stencil_apply_sharded``, same order of
    sums."""
    out = None
    for d in range(grid.dim):
        s = grid.shape[d]
        n = x.shape[d] // s
        lo, hi = neighbor_slabs(x, grid, d, periodic[d])
        ext = torch.cat([_blocks(lo, d, s), _blocks(x, d, s), _blocks(hi, d, s)], d + 1)
        for off in sorted(bands_per_axis[d]):
            w = torch.as_tensor(bands_per_axis[d][off], dtype=x.dtype, device=x.device)
            shape = [1] * x.dim()
            shape[d] = -1
            seg = ext.narrow(d + 1, 1 + off, n).flatten(d, d + 1)
            t = w.reshape(shape) * seg
            out = t if out is None else out + t
    return out
