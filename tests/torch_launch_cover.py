"""The cells a launch plan covers, by the index maps the CUDA kernels
use (csrc/momentum3d.cu momentum3d_kernel, csrc/poisson3d.cu
poisson3d_kernel, csrc/chain3d.cu chain3d_kernel over its face box,
csrc/poisson2d.cu and csrc/momentum2d.cu through stencil_common.cuh
Lane2D, csrc/probes.cu copy_scale_kernel), computed on the CPU: per axis, how
many threads write each index. The maps are products of per-axis maps, so
a plan covers every cell exactly once where every axis' counts are all 1."""

import numpy as np


def march3d_cover(plan, shape):
    """(counts along axis 0, 1, 2) of a ``MarchPlan`` on a box of ``shape``
    indices: block z takes planes z*run .. z*run + run - 1 below N0; thread
    row y of block y' the row y'*rows + y; lane x of block x' the index
    x'*32 + x below N2."""
    gx, gy, gz = plan.grid
    n0, n1, n2 = shape
    c0 = np.zeros(n0, int)
    for z in range(gz):
        c0[z * plan.run:min(z * plan.run + plan.run, n0)] += 1
    j = (np.arange(gy)[:, None] * plan.rows + np.arange(plan.rows)[None, :]).ravel()
    k = (np.arange(gx)[:, None] * 32 + np.arange(32)[None, :]).ravel()
    return c0, np.bincount(j[j < n1], minlength=n1), np.bincount(k[k < n2], minlength=n2)


def march3d_cells(plan, shape):
    """The count of every index, thread by thread (small shapes only)."""
    gx, gy, gz = plan.grid
    counts = np.zeros(shape, int)
    for z, y, x in np.ndindex(gz, gy, gx):
        i = np.arange(z * plan.run, min(z * plan.run + plan.run, shape[0]))
        for ty, tx in np.ndindex(plan.rows, 32):
            j, k = y * plan.rows + ty, x * 32 + tx
            if j < shape[1] and k < shape[2]:
                counts[i, j, k] += 1
    return counts


def copy_cover(plan, rows_total, columns):
    """(counts by row, counts by column) of a ``CopyPlan`` over a field of
    ``rows_total`` rows of ``columns`` vectors: block (x, y), thread
    (t, g) takes column x*threads + t and the block's rows g, g + groups,
    ... (unroll of them per pass)."""
    gx, gy = plan.grid
    by_row = np.zeros(rows_total, int)
    for y in range(gy):
        r0, r1 = y * plan.rows, min(y * plan.rows + plan.rows, rows_total)
        for g in range(plan.groups):
            for r in range(r0 + g, r1, plan.unroll * plan.groups):
                rr = r + plan.groups * np.arange(plan.unroll)
                by_row[rr[rr < r1]] += 1
    c = (np.arange(gx)[:, None] * plan.threads + np.arange(plan.threads)[None, :]).ravel()
    return by_row, np.bincount(c[c < columns], minlength=columns)


def march2d_cover(plan, shape, reach):
    """(counts by row, counts by column) of a ``March2DPlan`` on a block
    of ``shape`` cells whose stencil reaches ``reach`` columns to each
    side: block (x, y) takes rows y*run .. y*run + run - 1 below N0; warp
    w = x*rows + threadIdx.y owns the columns from w*cols, cols = (32 -
    2*halo)*vec with halo = ceil(reach / vec) end lanes on each side; lane
    t with halo <= t < 32 - halo writes the vec cells from w*cols + (t -
    halo)*vec where that column lies below N1 (a cell past N1 lengthens the
    column counts)."""
    gx, gy = plan.grid
    n0, n1 = shape
    rows = np.zeros(n0, int)
    for y in range(gy):
        rows[y * plan.run:min(y * plan.run + plan.run, n0)] += 1
    halo = -(-reach // plan.vec)
    cols = (32 - 2 * halo) * plan.vec
    js = (np.arange(gx * plan.rows)[:, None] * cols
          + (np.arange(halo, 32 - halo)[None, :] - halo) * plan.vec).ravel()
    js = js[js < n1]
    j = (js[:, None] + np.arange(plan.vec)[None, :]).ravel()
    return rows, np.bincount(j, minlength=n1)
