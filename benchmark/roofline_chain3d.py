"""The bytes of each stage of the 3-D chain (the interp/div/grad stages
of the coupled apply and the ABF pre and post stages), counted as
``roofline.py`` counts the stencils: each input read once and each output
written once, at the call's shape and dtype, whatever implements it. A
stage reads and writes cell fields (one value a cell) and face fields
(component a on nfaces(a) faces along axis a: N_a on a periodic axis,
N_a + 1 otherwise), and reads the band rows of each axis (CHAIN_ROWS per
face index) in the fields' dtype."""

from __future__ import annotations

import math

from benchmark.roofline import ITEMSIZE

# the band rows per face index of each axis (G, T, R, D, DT, Gst, ...)
CHAIN_ROWS = 24
# (cell fields, face groups) read and written by each stage; a face group
# is one face field per axis
STAGES = {
    # (Av, v, U, p) -> (Av + G p, U - T v - R p, D U)
    "coupled": ((7, 1), (4, 1)),
    # (v, rU, rp) -> (rU + T v, rp - D U*)
    "pre": ((4, 1), (1, 1)),
    # (v*, U*, p) -> (v* - G p, U* - Gst p)
    "post": ((4, 1), (3, 1)),
}


def nfaces(shape, periodic) -> tuple:
    return tuple(int(n) + (0 if per else 1) for n, per in zip(shape, periodic))


def chain3d_bytes(stage: str, shape, periodic, dtype: str) -> int:
    """Bytes of one call of ``stage`` on a grid of ``shape`` cells."""
    cells = math.prod(shape)
    box = nfaces(shape, periodic)
    faces = sum(cells // shape[a] * box[a] for a in range(3))
    (cin, fin), (cout, fout) = STAGES[stage]
    return ((cin + cout) * cells + (fin + fout) * faces
            + CHAIN_ROWS * sum(box)) * ITEMSIZE[dtype]
