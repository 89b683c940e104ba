"""Matrix-free banded stencil application along one grid axis.

Counterpart of fluca_tpu.ops.banded (the reference's matrix-free
FlucaFDApply sweep, fluca/src/fd/interface/fdapply.c:47-121). An
operator along axis ``d`` is a small dict ``{offset: coeffs}`` where
``coeffs`` is a 1-D array over the output index; application is

    y[..., i, ...] = sum_off coeffs[off][i] * x[..., i + off, ...]

Reads outside a non-periodic axis are zero; on a periodic axis they
wrap. Boundary-modified rows are baked into the coefficient tables on
the host in float64.

Input and output may live on different staggered locations (cell
centers vs faces), so input length ``n_in`` and output length
``n_out`` may differ by one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def broadcast_1d(w, ndim: int, axis: int):
    """Reshape a 1-D coefficient tensor for broadcasting along
    ``axis``."""
    shape = [1] * ndim
    shape[axis] = -1
    return w.reshape(shape)


def shifted(x, axis: int, off: int, n_out: int, periodic: bool):
    """Return y with y[i] = x[i + off] along ``axis`` for i in
    [0, n_out); entries reading outside x are zero (non-periodic) or
    wrap (periodic, which requires n_out == x.shape[axis])."""
    n_in = x.shape[axis]
    if periodic:
        if n_out != n_in:
            raise ValueError(f"periodic shift needs n_out == n_in ({n_out} != {n_in})")
        return torch.roll(x, -off, axis) if off else x
    if off == 0 and n_out == n_in:
        return x
    start = max(0, -off)
    stop = min(n_out, n_in - off)
    shape = list(x.shape)
    shape[axis] = n_out
    y = x.new_zeros(shape)
    if stop > start:
        y.narrow(axis, start, stop - start).copy_(
            x.narrow(axis, start + off, stop - start)
        )
    return y


@dataclass(frozen=True)
class AxisStencil:
    """Banded operator along one axis: {offset: 1-D coeff array}.

    Constructed on host in float64 numpy; ``device_bands`` converts it
    to tensors of the compute dtype on a device. ``n_out`` is the
    output extent along ``axis``; ``periodic`` selects wrap-around
    reads.
    """

    axis: int
    n_out: int
    periodic: bool
    bands: tuple[tuple[int, np.ndarray], ...]  # sorted by offset

    @classmethod
    def from_dict(cls, axis, n_out, periodic, band_dict) -> "AxisStencil":
        bands = []
        for off in sorted(band_dict):
            w = np.asarray(band_dict[off], dtype=np.float64)
            if w.shape != (n_out,):
                raise ValueError(f"band {off}: shape {w.shape} != ({n_out},)")
            if np.any(w != 0.0):
                bands.append((off, w))
        return cls(axis, n_out, periodic, tuple(bands))

    def as_dict(self) -> dict[int, np.ndarray]:
        return {off: w for off, w in self.bands}

    def device_bands(self, ndim: int, dtype, device, rows=slice(None)):
        """The bands as tensors broadcast along ``axis``; ``rows`` selects
        the output rows (a block's, under a rank-held grid)."""
        return tuple(
            (
                off,
                broadcast_1d(
                    torch.as_tensor(np.ascontiguousarray(w[rows]), dtype=dtype,
                                    device=device),
                    ndim, self.axis,
                ),
            )
            for off, w in self.bands
        )

    def to_dense(self, n_in: int) -> np.ndarray:
        """Dense matrix form, for tests on tiny grids and the coarse
        multigrid solve."""
        A = np.zeros((self.n_out, n_in))
        for off, w in self.bands:
            for i in range(self.n_out):
                j = i + off
                if self.periodic:
                    j %= n_in
                elif not (0 <= j < n_in):
                    continue
                A[i, j] += w[i]
        return A


def compose_axis_stencils(outer: AxisStencil, inner: AxisStencil) -> AxisStencil:
    """Band product C = outer @ inner along one axis (host-side).

    ``inner`` maps length n_in -> n_mid, ``outer`` maps n_mid ->
    n_out. Used to fuse operator chains (e.g. the pressure-Poisson
    D∘Gst) into a single banded stencil.
    """
    if outer.axis != inner.axis or outer.periodic != inner.periodic:
        raise ValueError("stencils act on different axes")
    n_out = outer.n_out
    n_mid = inner.n_out
    out_bands: dict[int, np.ndarray] = {}
    for a_off, a_w in outer.bands:
        for b_off, b_w in inner.bands:
            off = a_off + b_off
            acc = out_bands.setdefault(off, np.zeros(n_out))
            for i in range(n_out):
                j = i + a_off  # intermediate (inner-output) index
                if outer.periodic:
                    j %= n_mid
                elif not (0 <= j < n_mid):
                    continue
                acc[i] += a_w[i] * b_w[j]
    return AxisStencil.from_dict(
        outer.axis, n_out, outer.periodic, out_bands
    )


def apply_axis_stencil(device_bands, x, axis, n_out, periodic):
    """y = sum_off w_off * shifted(x, off). ``device_bands`` comes from
    AxisStencil.device_bands."""
    y = None
    for off, w in device_bands:
        term = w * shifted(x, axis, off, n_out, periodic)
        y = term if y is None else y + term
    if y is None:
        shape = list(x.shape)
        shape[axis] = n_out
        y = x.new_zeros(shape)
    return y
