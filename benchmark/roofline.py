"""The bytes each stencil operator of the step needs, and its least time
on the card.

A bound counts each input byte read once and each output byte written
once, at the call's shape and dtype, whatever implements the operator:
the fields in their dtype, the coefficient arrays in the arithmetic
dtype (float32 for bf16 fields). Every operator here is memory bound on
the card (its float32 operations over 67 TFLOP/s take less time than
its bytes over the memory rate), so the bound is bytes over
PEAK_BYTES_PER_S.
"""

from __future__ import annotations

import math

from benchmark.trace import matches

# The H100 SXM's memory rate, NVIDIA's data sheet (80 GB HBM3).
PEAK_BYTES_PER_S = 3.35e12

ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}
# fields read and written by each Poisson mode: apply (p -> Sp),
# residual (p, b -> b - Sp), smooth (p, b, w -> p + omega w (b - Sp))
POISSON_FIELDS = {"apply": 2, "residual": 3, "smooth": 4}
# the momentum kernel's per-axis band rows: 15 Laplacian (3 components
# x 5 offsets) and 12 convection (2 variants x 2 faces x 3 offsets)
MOMENTUM_BAND_ROWS = 27


def coef_itemsize(dtype: str) -> int:
    """Bytes of an arithmetic value for fields of ``dtype``."""
    return max(4, ITEMSIZE[dtype])


def poisson3d_bytes(mode: str, shape, dtype: str) -> int:
    """Shat p on one multigrid level of ``shape``: the mode's cell fields,
    and per axis three D@Gst band values and a cell width per index."""
    cells = math.prod(shape)
    return (POISSON_FIELDS[mode] * cells * ITEMSIZE[dtype]
            + 4 * sum(shape) * coef_itemsize(dtype))


def momentum3d_bytes(shape, periodic, dtype: str) -> int:
    """A v for the three components: v in and A v out (six cell fields),
    the step's face factors U0[a] and v0f[a][c] (four face arrays per
    axis a, of N_a faces on a periodic axis and N_a + 1 otherwise), and
    the per-axis band rows."""
    cells = math.prod(shape)
    faces = sum(4 * cells // shape[a] * (shape[a] + (0 if periodic[a] else 1))
                for a in range(3))
    return ((6 * cells + faces) * ITEMSIZE[dtype]
            + MOMENTUM_BAND_ROWS * sum(shape) * coef_itemsize(dtype))


def bound_seconds(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S


def call_bytes(call) -> int:
    """The bytes of one recorded wrapper call (``trace.Recorder``)."""
    op, mode, shape, periodic, dtype = call
    if op == "poisson3d":
        return poisson3d_bytes(mode, shape, dtype)
    if op == "momentum3d":
        return momentum3d_bytes(shape, periodic, dtype)
    raise ValueError(f"no count for {op!r}")


def roofline_share(trace, op: str, kernel: str):
    """The share in % of its roofline of the kernel family ``kernel``
    over the traced steps: the bound time of every recorded call of
    ``op`` over the device time of the kernels named ``kernel``; None
    where the trace holds neither."""
    if trace is None:
        return None
    calls = [c for c in trace.calls if c[0] == op]
    t = trace.kernel_seconds(lambda name: matches(name, kernel))
    if not calls or t <= 0:
        return None
    return 100.0 * sum(bound_seconds(call_bytes(c)) for c in calls) / t
