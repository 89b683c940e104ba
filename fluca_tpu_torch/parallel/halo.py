"""Explicit neighbour exchange between the shards of a device grid.

Counterpart of fluca_tpu.parallel.halo and of
``fluca_tpu.parallel.pallas_sharded._neighbor_slabs`` (the reference's
DMGlobalToLocal ghost scatters, fluca/src/mesh/impl/cart/cart.c:88-104),
which exchange boundary slabs with ``lax.ppermute`` inside ``shard_map``.

Two transports, by the form of the grid (``parallel/mesh.py``):
- ``DeviceGrid``: the shards are boxes of one global tensor on one
  device; an exchange gathers, for every shard at once, the planes that
  lie just past its block, with one ``index_select`` per axis.
- ``RankGrid``: each rank holds its own block; ``rank_slabs`` sends this
  rank's edge planes to its neighbours and receives theirs, with one
  ``batch_isend_irecv`` per axis (``distributed.Transport``).

Conventions as in the reference: fields are split block-wise along the
grid axes; a periodic axis wraps around the whole grid; a non-periodic
global boundary receives zeros (the boundary-folded coefficients are
zero there). With one shard on an axis this degenerates to the wrap
(periodic) or zeros: the unsharded kernels' own edge convention.

A field of a ``RankGrid`` is this rank's block, and so is every result
here: ``halo_exchange`` returns the block with its ghost layers,
``stencil_apply_sharded`` and ``stencil_apply_sharded_overlapped`` the
block of the stencil's output. ``stencil_apply_sharded_overlapped``
(halo.py:122 there) posts every send first, applies the stencil to the
block's own data, and folds the received planes in last. Under nccl the
transfer runs on NCCL's own stream while the interior apply is queued on
the current one. Under gloo the planes are staged through the host
synchronously and the receive is a host wait, so nothing is claimed to
overlap there; on a ``DeviceGrid`` the exchange is an ``index_select``
and there is nothing to overlap either.
"""

from __future__ import annotations

import functools

import torch

from fluca_tpu_torch.ops.banded import shifted
from fluca_tpu_torch.parallel.mesh import DeviceGrid, RankGrid


@functools.lru_cache(maxsize=None)
def _slab_index(N: int, nshards: int, width: int, device: torch.device):
    """Indices along an axis of N cells split into ``nshards`` blocks:
    for each block the ``width`` planes below it, then for each the
    ``width`` planes above it, wrapped around the axis."""
    n = N // nshards
    lo = [(k * n - width + i) % N for k in range(nshards) for i in range(width)]
    hi = [((k + 1) * n + i) % N for k in range(nshards) for i in range(width)]
    return torch.tensor(lo + hi, device=device)


class _Ready:
    """An exchange that is already complete (no transfer to wait for)."""

    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def wait(self):
        return self.lo, self.hi


class _RankSlabs:
    """A posted rank exchange: ``wait()`` gives (lo, hi)."""

    def __init__(self, pending, zeros, slots):
        self.pending, self.zeros, self.slots = pending, zeros, slots

    def wait(self):
        got = iter(self.pending.wait())
        return tuple(None if s is None else next(got) if s else self.zeros[i]()
                     for i, s in enumerate(self.slots))


def start_rank_slabs(x, grid: RankGrid, axis: int, periodic: bool, lo_width: int = 1,
                     hi_width: int = 1):
    """Post the exchange of ``rank_slabs``; ``.wait()`` returns its
    (lo, hi)."""
    n = x.shape[axis]
    if max(lo_width, hi_width) > n:
        raise ValueError(f"axis {axis}: a block of {n} planes cannot give "
                         f"{max(lo_width, hi_width)} edge planes")

    def plane_shape(w):
        return tuple(w if d == axis else m for d, m in enumerate(x.shape))

    def zeros(w):
        return lambda: x.new_zeros(plane_shape(w))

    if grid.shape[axis] == 1:
        if periodic:
            lo = x.narrow(axis, n - lo_width, lo_width).contiguous() if lo_width else None
            hi = x.narrow(axis, 0, hi_width).contiguous() if hi_width else None
        else:
            lo = zeros(lo_width)() if lo_width else None
            hi = zeros(hi_width)() if hi_width else None
        return _Ready(lo, hi)
    lo_peer = grid.neighbor(axis, -1, periodic)
    hi_peer = grid.neighbor(axis, 1, periodic)
    # a plane carrying the sender's last planes is the receiver's lo ghost
    # (tag 2 axis), its first planes the receiver's hi ghost (2 axis + 1);
    # every rank posts: send last -> hi, recv lo <- lo, send first -> lo,
    # recv hi <- hi, which pairs them in order under nccl too
    sends, recvs, slots = [], [], []
    for w, to, frm, tag, src in ((lo_width, hi_peer, lo_peer, 2 * axis, n - lo_width),
                                 (hi_width, lo_peer, hi_peer, 2 * axis + 1, 0)):
        if not w:
            slots.append(None)
            continue
        if to is not None:
            sends.append((to, x.narrow(axis, src, w), tag))
        if frm is not None:
            recvs.append((frm, plane_shape(w), x.dtype, tag))
        slots.append(frm is not None)
    pending = grid.transport.start_exchange(sends, recvs)
    return _RankSlabs(pending, (zeros(lo_width), zeros(hi_width)), slots)


def rank_slabs(x, grid: RankGrid, axis: int, periodic: bool, lo_width: int = 1,
               hi_width: int = 1):
    """(lo, hi) for this rank's block ``x`` of a ``RankGrid``: the
    ``lo_width`` planes of the low neighbour's block just below it and the
    ``hi_width`` planes of the high neighbour's just above it (None for a
    width of 0), each a new contiguous tensor; zeros past a non-periodic
    wall, and the block's own wrap where one rank lies on the axis. The
    blocks may differ in extent along ``axis`` (a wall axis' face arrays:
    the last rank holds face N): each rank sends its own first and last
    planes."""
    return start_rank_slabs(x, grid, axis, periodic, lo_width, hi_width).wait()


def neighbor_slabs(x, grid, axis: int, periodic: bool, width: int = 1):
    """(lo, hi): for each shard along ``axis``, the ``width`` planes of its
    low neighbour just below its block and those of its high neighbour
    just above it. On a ``DeviceGrid`` each has ``x``'s shape with
    ``grid.shape[axis] * width`` planes along ``axis``, shard k's at k *
    width ..; on a ``RankGrid`` ``x`` is this rank's block and each has
    ``width`` planes (``rank_slabs``): the layout the one-card exchange
    gives for one shard. Zeros past a non-periodic global boundary, the
    other end of the grid on a periodic axis. Counterpart of
    ``pallas_sharded._neighbor_slabs``."""
    if isinstance(grid, RankGrid):
        return rank_slabs(x, grid, axis, periodic, width, width)
    N, s = x.shape[axis], grid.shape[axis]
    if N % s or N // s < width:
        raise ValueError(f"axis {axis} of {N} cells does not split into {s} "
                         f"blocks of at least {width}")
    both = x.index_select(axis, _slab_index(N, s, width, x.device))
    if not periodic:
        both.narrow(axis, 0, width).zero_()
        both.narrow(axis, 2 * s * width - width, width).zero_()
    return both.split(s * width, axis)


def _start_slabs(x, grid, axis, periodic, width=1):
    """``neighbor_slabs`` posted (a rank exchange) or done (one card)."""
    if isinstance(grid, RankGrid):
        return start_rank_slabs(x, grid, axis, periodic, width, width)
    return _Ready(*neighbor_slabs(x, grid, axis, periodic, width))


def _nblocks(grid, axis) -> int:
    """The blocks along ``axis`` of a field held here: one on a rank."""
    return 1 if isinstance(grid, RankGrid) else grid.shape[axis]


def _blocks(x, axis, nshards):
    """``x`` with ``axis`` split into (nshards, block)."""
    return x.unflatten(axis, (nshards, x.shape[axis] // nshards))


def halo_exchange(grid, x, periodic, width: int = 1):
    """Every shard's block extended by ``width`` ghost cells on each side of
    every grid axis, filled from its neighbours (zeros past a non-periodic
    boundary). On a ``DeviceGrid`` the blocks lie side by side as the
    reference lays them out, (N_a + 2 * width * shards_a) along each axis;
    on a ``RankGrid`` the result is this rank's extended block. The axes
    are exchanged in turn, each on the result of the last, so the corners
    come from the diagonal neighbours, as in the reference."""
    for a in range(grid.dim):
        s = _nblocks(grid, a)
        lo, hi = neighbor_slabs(x, grid, a, periodic[a], width)
        x = torch.cat([_blocks(lo, a, s), _blocks(x, a, s), _blocks(hi, a, s)],
                      a + 1).flatten(a, a + 1)
    return x


def _local_bands(grid, bands_per_axis, x):
    """Each axis' {offset: coefficients over the rows held here}, in x's
    dtype on its device: a rank takes its rows of global 1-D arrays (or
    arrays already of its block's length)."""
    out = []
    for d in range(grid.dim):
        n = x.shape[d]
        row = {}
        for off, w in bands_per_axis[d].items():
            w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
            if isinstance(grid, RankGrid) and w.shape[0] != n:
                w = w.narrow(0, grid.coords[d] * n, n)
            row[off] = w
        out.append(row)
    return out


def _along(w, d, ndim):
    shape = [1] * ndim
    shape[d] = -1
    return w.reshape(shape)


def stencil_apply_sharded(grid, bands_per_axis, x, periodic):
    """Banded stencil apply with an explicit halo exchange: each shard
    takes one ghost layer per axis from its neighbours, then applies the
    tridiagonal per-axis bands on its block; the result is the global
    field (``DeviceGrid``) or this rank's block of it (``RankGrid``).
    ``bands_per_axis[d]`` is {offset in (-1, 0, 1): 1-D coefficient array
    of length N_d (or, on a rank, of its block's length)}. Counterpart of
    ``fluca_tpu.parallel.halo.stencil_apply_sharded``, same order of
    sums."""
    bands = _local_bands(grid, bands_per_axis, x)
    out = None
    for d in range(grid.dim):
        s = _nblocks(grid, d)
        n = x.shape[d] // s
        lo, hi = neighbor_slabs(x, grid, d, periodic[d])
        ext = torch.cat([_blocks(lo, d, s), _blocks(x, d, s), _blocks(hi, d, s)], d + 1)
        for off in sorted(bands[d]):
            seg = ext.narrow(d + 1, 1 + off, n).flatten(d, d + 1)
            t = _along(bands[d][off], d, x.dim()) * seg
            out = t if out is None else out + t
    return out


def stencil_apply_sharded_overlapped(grid, bands_per_axis, x, periodic):
    """Communication-overlapped banded stencil apply: the same result as
    ``stencil_apply_sharded`` up to the order of its sums. Every halo send
    is posted first; the interior apply runs on the block's own data
    (zero-filled past its edges); the received planes fold in last, as
    one-plane corrections with the edge rows' -1 and +1 coefficients.
    Counterpart of ``fluca_tpu.parallel.halo.stencil_apply_sharded_overlapped``
    (halo.py:122-226); tridiagonal bands only (offsets in {-1, 0, 1})."""
    for d in range(grid.dim):
        if not set(bands_per_axis[d]) <= {-1, 0, 1}:
            raise ValueError("the overlapped apply takes width-1 stencils only")
    bands = _local_bands(grid, bands_per_axis, x)
    # 1. every send first
    pending = [_start_slabs(x, grid, d, periodic[d]) for d in range(grid.dim)]
    # 2. the interior, on local data only
    out = None
    for d in range(grid.dim):
        s = _nblocks(grid, d)
        n = x.shape[d] // s
        xb = _blocks(x, d, s)
        for off in sorted(bands[d]):
            seg = shifted(xb, d + 1, off, n, False).flatten(d, d + 1)
            t = _along(bands[d][off], d, x.dim()) * seg
            out = t if out is None else out + t
    # 3. the received planes at the edge rows
    for d in range(grid.dim):
        s = _nblocks(grid, d)
        n = x.shape[d] // s
        lo, hi = pending[d].wait()
        ob = _blocks(out, d, s)
        for off, plane, row in ((-1, lo, 0), (1, hi, n - 1)):
            if off not in bands[d]:
                continue
            w = _blocks(bands[d][off], 0, s).select(1, row)
            edge = ob.select(d + 1, row)
            edge += _along(w, d, x.dim()) * plane
        out = ob.flatten(d, d + 1)
    return out
