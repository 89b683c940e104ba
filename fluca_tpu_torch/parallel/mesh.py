"""Logical device grids for domain decomposition.

Counterpart of fluca_tpu.parallel.mesh (the reference's
block-structured decomposition of the Cartesian grid over an MPI rank
grid, fluca/src/mesh/impl/cart/cart.c:88-104). A grid splits each grid
axis into equal blocks, one shard per grid point; shard (k0, k1[, k2])
owns the cells ``k_a * n_a .. (k_a + 1) * n_a`` along each axis a, with
n_a = N_a / shape[a].

Two forms:
- ``DeviceGrid``: every shard lies on the one torch device of the
  solver, the counterpart of the reference's virtual devices (its tests
  run 8 CPU devices in one process). A shard is a box of the global
  tensor; the sharded kernels (``parallel/sharded.py``) read each box in
  place, with the planes that cross a shard boundary handed to them by
  an explicit neighbour exchange (``parallel/halo.py``).
- ``RankGrid``: one shard per ``torch.distributed`` rank, each rank on its
  own device (or ranks sharing one card under gloo). A rank holds only
  its ``Block`` of every field; edge planes cross from rank to rank
  (``parallel/halo.py`` ``rank_slabs``) and sums are added over the
  ranks (``distributed.Transport``).

Faces are owned lo + hilast: along a split axis the rank at k owns faces
k n .. (k + 1) n - 1, and on a wall axis the last rank also owns face N.
A periodic axis has no face N. So every face lies on exactly one rank,
and a sum over the ranks counts it once. (The reference's GSPMD
placement leaves face arrays replicated along their axis,
fluca_tpu/parallel/mesh.py:81-97; its all-gathers are most of its
traffic, ICI_BYTES_2dev.json.)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

AXIS_NAMES = ("gx", "gy", "gz")
TRANSPORT_ITEM = ("shards on distinct devices need the rank-held grid (RankGrid; ROADMAP "
                  "queue 1, item 1a): one torch.distributed rank per shard, joined by "
                  "parallel.distributed.initialize_distributed, then make_device_grid")


@dataclass(frozen=True)
class DeviceGrid:
    """A logical grid of shards aligned with the grid axes: ``shape``
    shards per axis, ``devices`` the device of each shard in C order
    (all the same device)."""

    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not 1 <= len(self.shape) <= 3 or any(s < 1 for s in self.shape):
            raise ValueError(f"bad device grid shape {self.shape}")
        if len(self.devices) != int(np.prod(self.shape)):
            raise ValueError(f"grid {self.shape} needs {int(np.prod(self.shape))} "
                             f"devices, got {len(self.devices)}")
        if len(set(self.devices)) != 1:
            raise NotImplementedError(f"{TRANSPORT_ITEM}: got {set(self.devices)}")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXIS_NAMES[: self.dim]

    @property
    def device(self) -> torch.device:
        """The one device every shard lies on."""
        return self.devices[0]

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    def shards(self):
        """Every shard's grid coordinates, in C order."""
        return itertools.product(*(range(s) for s in self.shape))

    def coords(self, index: int) -> tuple[int, ...]:
        """The grid coordinates of shard ``index`` (C order)."""
        return tuple(int(c) for c in np.unravel_index(index, self.shape))

    def index(self, coords) -> int:
        """The shard index of grid coordinates ``coords``."""
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def divides(self, N) -> bool:
        """Whether the grid splits a grid of ``N`` cells evenly."""
        return len(tuple(N)) == self.dim and all(n % s == 0 for n, s in zip(N, self.shape))

    def local_shape(self, N) -> tuple[int, ...]:
        """The extents of each shard's block of a grid of ``N`` cells;
        raises ValueError where the grid does not divide ``N``."""
        if not self.divides(N):
            raise ValueError(f"grid {tuple(N)} not divisible by device grid {self.shape}")
        return tuple(n // s for n, s in zip(N, self.shape))

    def box(self, coords, N) -> tuple[slice, ...]:
        """The index box of shard ``coords`` in a grid of ``N`` cells."""
        n = self.local_shape(N)
        return tuple(slice(k * m, (k + 1) * m) for k, m in zip(coords, n))


@dataclass(frozen=True)
class Block:
    """One rank's part of a grid of ``N`` cells: along each axis the cells
    ``start .. start + n`` and, lo + hilast, the faces ``start .. start +
    nfaces(a)``. ``split`` marks the axes divided over more than one rank;
    ``at_lo``/``at_hi`` whether the block touches the low or high end of the
    grid (where a wall axis' boundary planes and face N live).
    ``Block.whole`` is the grid itself."""

    N: tuple[int, ...]
    periodic: tuple[bool, ...]
    start: tuple[int, ...]
    n: tuple[int, ...]
    split: tuple[bool, ...]

    @classmethod
    def whole(cls, N, periodic) -> "Block":
        N = tuple(int(x) for x in N)
        return cls(N, tuple(bool(p) for p in periodic), (0,) * len(N), N,
                   (False,) * len(N))

    @property
    def dim(self) -> int:
        return len(self.N)

    @property
    def cell_shape(self) -> tuple[int, ...]:
        return self.n

    def at_lo(self, a) -> bool:
        return self.start[a] == 0

    def at_hi(self, a) -> bool:
        return self.start[a] + self.n[a] == self.N[a]

    def nfaces(self, a) -> int:
        """The faces this block owns along ``a``: n, plus face N at the high
        end of a wall axis."""
        return self.n[a] + (1 if not self.periodic[a] and self.at_hi(a) else 0)

    def face_shape(self, a) -> tuple[int, ...]:
        return tuple(self.nfaces(a) if d == a else m for d, m in enumerate(self.n))

    def cells(self, a) -> slice:
        """The block's cells along ``a`` as a slice of the grid's."""
        return slice(self.start[a], self.start[a] + self.n[a])

    def faces(self, a) -> slice:
        """The block's faces along ``a`` as a slice of the grid's."""
        return slice(self.start[a], self.start[a] + self.nfaces(a))

    def cut(self, x, face=None):
        """The block of a global cell field ``x`` (``face=None``) or of a
        face array of axis ``face`` (numpy or torch; a view)."""
        idx = tuple(self.faces(a) if a == face else self.cells(a) for a in range(self.dim))
        return x[idx]


@dataclass(frozen=True, eq=False)
class RankGrid:
    """The rank-held form of a device grid: one shard per rank of a
    ``torch.distributed`` process group, in C order over ``shape``, this
    rank at ``coords`` on ``device``. ``transport`` carries the group and
    its backend (``distributed.Transport``)."""

    shape: tuple[int, ...]
    transport: object  # distributed.Transport

    def __post_init__(self):
        if not 1 <= len(self.shape) <= 3 or any(s < 1 for s in self.shape):
            raise ValueError(f"bad device grid shape {self.shape}")
        if self.transport.size != self.size:
            raise ValueError(f"grid {self.shape} has {self.size} shards, the process "
                             f"group {self.transport.size} ranks: one rank per shard")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXIS_NAMES[: self.dim]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.transport.device

    @property
    def rank(self) -> int:
        return self.transport.rank

    @property
    def coords(self) -> tuple[int, ...]:
        """This rank's grid coordinates."""
        return self.coords_of(self.rank)

    def coords_of(self, rank: int) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def rank_of(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def neighbor(self, axis: int, step: int, periodic: bool):
        """The rank ``step`` (+-1) along ``axis``: wrapped on a periodic
        axis, None past a wall."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            if not periodic:
                return None
            c[axis] %= self.shape[axis]
        return self.rank_of(c)

    def divides(self, N) -> bool:
        return len(tuple(N)) == self.dim and all(n % s == 0 for n, s in zip(N, self.shape))

    def local_shape(self, N) -> tuple[int, ...]:
        if not self.divides(N):
            raise ValueError(f"grid {tuple(N)} not divisible by device grid {self.shape}")
        return tuple(n // s for n, s in zip(N, self.shape))

    def block(self, N, periodic, rank=None) -> Block:
        """``rank``'s block (this rank's if None) of a grid of ``N`` cells."""
        n = self.local_shape(N)
        k = self.coords if rank is None else self.coords_of(rank)
        return Block(tuple(int(x) for x in N), tuple(bool(p) for p in periodic),
                     tuple(c * m for c, m in zip(k, n)), n, tuple(s > 1 for s in self.shape))

    def gather(self, x, N, periodic, face=None):
        """The global field of every rank's block ``x`` (a cell field, or a
        face array of axis ``face``), on every rank."""
        pad = face is not None and not periodic[face] and self.shape[face] > 1
        if pad:
            # the last rank along a wall axis holds one face more
            full = list(x.shape)
            full[face] = self.local_shape(N)[face] + 1
            buf = x.new_zeros(full)
            buf.narrow(face, 0, x.shape[face]).copy_(x)
            x = buf
        parts = self.transport.all_gather(x)
        out = x.new_empty(tuple(n + (0 if face != a or periodic[a] else 1)
                                for a, n in enumerate(N)))
        for r, part in enumerate(parts):
            blk = self.block(N, periodic, r)
            if pad:
                part = part.narrow(face, 0, blk.nfaces(face))
            out[tuple(blk.faces(a) if a == face else blk.cells(a)
                      for a in range(self.dim))] = part
        return out

    def allsum(self, x):
        return self.transport.allsum(x)


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device (an index left out is the
    current device's)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _factor(n: int, dim: int) -> tuple[int, ...]:
    """Split n devices into a near-square dim-d grid."""
    shape = [1] * dim
    remaining = n

    # greedy: repeatedly divide by smallest prime factor, assign to the
    # axis with the smallest current extent
    def smallest_prime(m):
        for p in (2, 3, 5, 7, 11, 13):
            if m % p == 0:
                return p
        return m

    while remaining > 1:
        p = smallest_prime(remaining)
        i = int(np.argmin(shape))
        shape[i] *= p
        remaining //= p
    return tuple(shape)


def make_device_grid(dim: int, devices=None, shape=None):
    """A ``dim``-D device grid.

    Under a process group of more than one rank
    (``distributed.initialize_distributed``) it is the rank-held
    ``RankGrid``: one shard per rank, ``shape`` (or the ranks factored into
    a near-square grid) of as many shards as there are ranks, this rank's
    block on its device (``devices``, if given, names that one device).

    Otherwise every shard lies on one device: with ``shape=None`` the
    number of ``devices`` given is factored into a near-square grid (one
    device gives the degenerate grid of one shard); with an explicit
    ``shape`` every shard lies on the one device given, the counterpart of
    the reference's virtual devices. ``devices`` defaults to ``cuda``;
    every entry must name the same device."""
    from fluca_tpu_torch.parallel import distributed

    if distributed.world_size() > 1:
        transport = distributed.default_transport()
        if devices is not None and not all(same_device(d, transport.device) for d in devices):
            raise ValueError(f"a rank-held grid lies on this rank's device "
                             f"{transport.device}, not {sorted(map(str, devices))}")
        shape = _factor(transport.size, dim) if shape is None else tuple(int(s) for s in shape)
        if len(shape) != dim:
            raise ValueError(f"grid shape {shape} is not {dim}-D")
        return RankGrid(shape=shape, transport=transport)
    devices = [torch.device(d) for d in (devices if devices is not None else ["cuda"])]
    if not devices:
        raise ValueError("make_device_grid needs at least one device")
    if len(set(devices)) != 1:
        raise NotImplementedError(f"{TRANSPORT_ITEM}: got {sorted(map(str, set(devices)))}")
    shape = _factor(len(devices), dim) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != dim:
        raise ValueError(f"grid shape {shape} is not {dim}-D")
    return DeviceGrid(shape=shape, devices=(devices[0],) * int(np.prod(shape)))
