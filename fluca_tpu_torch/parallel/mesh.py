"""Logical device grids for domain decomposition.

Counterpart of fluca_tpu.parallel.mesh (the reference's
block-structured decomposition of the Cartesian grid over an MPI rank
grid, fluca/src/mesh/impl/cart/cart.c:88-104). A ``DeviceGrid`` splits
each grid axis into equal blocks, one shard per grid point; shard
(k0, k1[, k2]) owns the index box ``k_a * n_a .. (k_a + 1) * n_a`` along
each axis a, with n_a = N_a / shape[a].

In this package every shard of a grid lies on the one torch device of
the solver: the counterpart of the reference's virtual devices (its
tests run 8 CPU devices in one process). A shard is a box of the global
tensor; the sharded kernels (``parallel/sharded.py``) read each box in
place, with the planes that cross a shard boundary handed to them by an
explicit neighbour exchange (``parallel/halo.py``). Placing shards on
distinct cards needs a multi-process transport (torch.distributed),
which is ROADMAP queue 1 item 1.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

AXIS_NAMES = ("gx", "gy", "gz")
TRANSPORT_ITEM = ("shards on distinct devices need the torch.distributed "
                  "transport (ROADMAP queue 1, item 1)")


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


def make_device_grid(dim: int, devices=None, shape=None) -> DeviceGrid:
    """A ``dim``-D device grid. With ``shape=None`` the number of
    ``devices`` given is factored into a near-square grid (one device
    gives the degenerate grid of one shard). With an explicit ``shape``
    every shard lies on the one device given: the counterpart of the
    reference's virtual devices. ``devices`` defaults to ``cuda``; every
    entry must name the same device."""
    devices = [torch.device(d) for d in (devices if devices is not None else ["cuda"])]
    if not devices:
        raise ValueError("make_device_grid needs at least one device")
    if len(set(devices)) != 1:
        raise NotImplementedError(f"{TRANSPORT_ITEM}: got {sorted(map(str, set(devices)))}")
    shape = _factor(len(devices), dim) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != dim:
        raise ValueError(f"grid shape {shape} is not {dim}-D")
    return DeviceGrid(shape=shape, devices=(devices[0],) * int(np.prod(shape)))
