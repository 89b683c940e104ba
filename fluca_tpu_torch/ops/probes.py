"""Hand-written CUDA kernels of the bench and the memory probes.

Counterpart of the copy and stripped-stencil ``pallas_call`` s of the
repo's bench and probe scripts (``bench.py`` spmv_roofline and
poisson3d_roofline, ``examples/probe512.py``, ``probe512split.py``,
``probe_poisson512.py`` and ``profile512.py``): the yardsticks that size
the card's own memory behaviour and split the time of the 3-D Poisson
kernel. Three kernels, float32 only, in ``csrc/probes.cu``, built into
the one kernel library of ``ops/cuda_stencil.py``:

- ``copy_scale(*arrays, rows)``: ``a * 1.0000001`` of one or two
  contiguous tensors of one shape (rank 2 or 3) in one launch, ``rows``
  leading-axis rows per thread block (the counterpart of the TPU's tile
  height TM);
- ``copy_rolls(a, rows)``: ``a * 1.0000001 + 1e-20 * (roll(a, 1, 1) +
  roll(a, 1, 2))`` of a 3-D tensor, ``rows`` planes per block;
- ``poisson3d_variant(mode, p, coeffs, edges)``: the 3-D Poisson apply
  of ``probe_poisson512.py``'s ``variant_call`` with its bodies
  ``rebuilt``, ``noroll`` and ``nocomp`` (``poisson3d_variant_plain``
  says what each computes).

The factors are the float32 roundings of 1.0000001 and 1e-20, as JAX
rounds a weak-typed Python float against a float32 array. Each kernel
has a plain PyTorch version beside it; a wrapper takes it only for
tensors on the CPU (in their own dtype), and for a CUDA tensor launches
the kernel or raises. Each wrapper counts its launches and keeps the
(shape, instance, launch parameters) ledger of ``cuda_stencil._Kernel``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from fluca_tpu_torch.ops.banded import broadcast_1d, shifted
from fluca_tpu_torch.ops.cuda_stencil import (
    Poisson3DCoeffs, _check_tensors, _Kernel, _launch_target, _poisson3d, _stream_ptr,
    _upcast, poisson3d_launch_plan,
)

SCALE = 1.0000001
TINY = 1e-20
VARIANT_MODES = {"rebuilt": 0, "noroll": 1, "nocomp": 2}
# csrc/probes.cu copy_scale_kernel's block by rows per block: (threads
# across the columns, rows of threads that take the block's rows in turn,
# rows of loads in flight per thread), for rows of at least the first
# entry; measured on the H100 against torch.mul at the path's shapes.
# And the CUDA grid's y extent.
COPY_GEOMETRY = ((64, (32, 32, 4)), (5, (64, 4, 4)), (1, (128, 4, 2)))
_MAX_GRID_Y = 65535
_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check_field(name, ref, fields, ranks):
    """Every field a tensor of ``ref``'s shape, of rank in ``ranks``, on
    its device, in its dtype, contiguous."""
    for label, t in fields.items():
        if not isinstance(t, torch.Tensor) or t.dim() not in ranks \
                or t.shape != ref.shape:
            raise ValueError(f"{name}: {label} must be a rank-{'/'.join(map(str, ranks))} "
                             f"tensor of shape {tuple(ref.shape)}")
    _check_tensors(name, ref, fields)


def _check_f32(name, x):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: no {x.dtype} instance (float32)")


def _check_rows(name, rows, n):
    """``rows`` a positive int whose blocks fit the CUDA grid's y extent
    over ``n`` rows."""
    if not isinstance(rows, int) or rows < 1:
        raise ValueError(f"{name}: rows must be a positive int, not {rows!r}")
    if -(-n // rows) > _MAX_GRID_Y:
        raise ValueError(f"{name}: {n} rows in blocks of {rows} exceed the grid")


# ----------------------------------------------------------------------
# copy_scale
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class CopyPlan:
    """One copy_scale launch over a field viewed as R rows of C floats:
    blocks of ``threads`` x ``groups`` threads, each block ``rows`` rows
    by ``threads * vec`` columns, thread row g taking the block's rows g,
    g + groups, ..., ``unroll`` per pass; ``grid`` is (column blocks, row
    blocks) and a launch has one z layer per pair."""

    grid: tuple[int, int]
    rows: int
    vec: int
    threads: int
    groups: int
    unroll: int


@functools.lru_cache(maxsize=None)
def copy_scale_plan(shape, rows, vec) -> CopyPlan:
    """The launch of copy_scale on a field of ``shape`` (a tuple; leading
    axis the rows) with ``rows`` rows per block and ``vec`` floats per
    access, from COPY_GEOMETRY (the groups at most ``rows``). Raises where
    the row blocks exceed the CUDA grid. Cached: the bench times the copy
    eagerly, and the wrapper's host time must stay below the kernel's."""
    R = int(shape[0])
    C = math.prod(shape[1:])
    if R < 1 or C < 1 or vec not in (1, 4) or C % vec:
        raise ValueError(f"copy_scale: no launch for shape {tuple(shape)}, vec {vec}")
    _check_rows("copy_scale", rows, R)
    threads, groups, unroll = next(g for least, g in COPY_GEOMETRY if rows >= least)
    gx = -(-(C // vec) // threads)
    if gx >= 2**31:
        raise ValueError(f"copy_scale: {C} columns exceed the grid")
    return CopyPlan((gx, -(-R // rows)), rows, vec, threads, min(groups, rows), unroll)


def copy_scale_plain(*arrays):
    """Plain PyTorch version of ``copy_scale``: each array times
    1.0000001, in its own dtype (the factor rounded to it once)."""
    out = tuple(a * SCALE for a in arrays)
    return out[0] if len(out) == 1 else out


class CopyScaleKernel(_Kernel):
    """Wrapper of the copy kernel (csrc/probes.cu copy_scale_kernel):
    ``copy_scale(a[, b], rows=TM)`` returns ``a * 1.0000001`` (and ``b *
    1.0000001``) from one launch over both pairs. The ledger keys a
    launch by (shape, (rows, pairs, vec, threads, groups, unroll)): vec 4
    where the row length is a multiple of 4 and every address is 16-byte
    aligned (float4 accesses), else 1; the rest from ``copy_scale_plan``."""

    name = "copy_scale"
    source = "probes.cu"
    instances = ("f32",)
    argtypes = [_VP, _VP, _VP, _VP, _CL, _CL, _CI, _CI, _CI, _CI, _CI, _CI, _VP]

    def __call__(self, *arrays, rows):
        if len(arrays) not in (1, 2):
            raise ValueError(f"{self.name}: takes one or two arrays, not {len(arrays)}")
        a = arrays[0]
        _check_field(self.name, a, {f"arrays[{n}]": x for n, x in enumerate(arrays)},
                     (2, 3))
        _check_rows(self.name, rows, a.shape[0])
        if _launch_target(self.name, a) == "cpu":
            return copy_scale_plain(*arrays)
        _check_f32(self.name, a)
        if a.numel() == 0:
            raise ValueError(f"{self.name}: empty field {tuple(a.shape)}")
        R = a.shape[0]
        C = a.numel() // R
        outs = tuple(torch.empty_like(x) for x in arrays)
        vec = 4 if C % 4 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in (*arrays, *outs)) else 1
        plan = copy_scale_plan(tuple(a.shape), rows, vec)
        pairs = [(x.data_ptr(), o.data_ptr()) for x, o in zip(arrays, outs)]
        if len(pairs) == 1:
            pairs.append((None, None))
        geometry = (plan.threads, plan.groups, plan.unroll)
        self._launch(torch.float32, (tuple(a.shape), (rows, len(arrays), vec, *geometry)),
                     *pairs[0], *pairs[1], R, C, rows, len(arrays), vec, *geometry,
                     _stream_ptr(a))
        return outs[0] if len(outs) == 1 else outs


copy_scale = CopyScaleKernel()


# ----------------------------------------------------------------------
# copy_rolls
# ----------------------------------------------------------------------

def copy_rolls_plain(a):
    """Plain PyTorch version of ``copy_rolls``: a * 1.0000001 + 1e-20 *
    (roll(a, 1, 1) + roll(a, 1, 2)), in that order of operations
    (examples/profile512.py:277-285)."""
    return a * SCALE + TINY * (torch.roll(a, 1, 1) + torch.roll(a, 1, 2))


class CopyRollsKernel(_Kernel):
    """Wrapper of the copy with two in-plane neighbour reads
    (csrc/probes.cu copy_rolls_kernel): ``copy_rolls(a, rows=TM)`` on a
    3-D tensor, ``rows`` planes per block; ledger key (shape, rows)."""

    name = "copy_rolls"
    source = "probes.cu"
    instances = ("f32",)
    argtypes = [_VP, _VP, _CI, _CI, _CI, _CI, _VP]

    def __call__(self, a, rows):
        _check_field(self.name, a, {"a": a}, (3,))
        _check_rows(self.name, rows, a.shape[0])
        if _launch_target(self.name, a) == "cpu":
            return copy_rolls_plain(a)
        _check_f32(self.name, a)
        N0, N1, N2 = a.shape
        if 0 in a.shape or N1 * N2 >= 2**31:
            raise ValueError(f"{self.name}: unsupported shape {tuple(a.shape)}")
        out = torch.empty_like(a)
        self._launch(torch.float32, (tuple(a.shape), rows), a.data_ptr(), out.data_ptr(),
                     N0, N1, N2, rows, _stream_ptr(a))
        return out


copy_rolls = CopyRollsKernel()


# ----------------------------------------------------------------------
# poisson3d_variant
# ----------------------------------------------------------------------

def variant_edge_shapes(shape):
    """The shapes of the edge inputs (le1, re1, le2, re2): the
    replacements of rows 0 and N1-1, then of columns 0 and N2-1, as the
    reference's (N0, 1, N2) and (N0, N1, 1) arrays."""
    N0, N1, N2 = shape
    return ((N0, 1, N2),) * 2 + ((N0, N1, 1),) * 2


def poisson3d_variant_plain(mode, p, c: Poisson3DCoeffs, edges):
    """Plain PyTorch version of ``poisson3d_variant``, the bodies of
    examples/probe_poisson512.py:159-206 on the port's coefficient
    arrays:

    - ``rebuilt``: the Poisson 3-D apply (``_poisson3d``'s arithmetic)
      with the axis-0 neighbours read as ``shifted`` reads them (a wrap
      where ``c.periodic[0]``, else 0) and the in-plane neighbours of row
      0 / N1-1 and column 0 / N2-1 taken from the edges (le1, re1, le2,
      re2), the TPU kernel's roll patches. With the field's own wrapped
      planes (or zeros at a wall) as edges it is the apply;
    - ``noroll``: the same with every in-plane neighbour read as the
      centre value, before the edge replacement;
    - ``nocomp``: p * 1.0000001.

    Computed in the coefficients' dtype, returned in the field's."""
    if mode not in VARIANT_MODES:
        raise ValueError(f"poisson3d_variant: unknown mode {mode!r}")
    if mode == "nocomp":
        return p * SCALE
    out_dtype = p.dtype
    p, *edges = _upcast(c.a0.dtype, p, *edges)
    lo_hi = {1: edges[:2], 2: edges[2:]}

    def sh(a, off):
        if a == 0:
            return shifted(p, 0, off, p.shape[0], c.periodic[0])
        n = p.shape[a]
        inner = p if mode == "noroll" else shifted(p, a, off, n, False)
        at_edge = broadcast_1d(torch.arange(n, device=p.device) == (0 if off < 0 else n - 1),
                               3, a)
        return torch.where(at_edge, lo_hi[a][0 if off < 0 else 1], inner)

    return _poisson3d("apply", p, c, None, None, 0.0, sh).to(out_dtype)


def variant_launch_plan(shape):
    """The launch of ``poisson3d_variant`` at ``shape``: the Poisson 3-D
    apply's (grid, block rows, run and shared memory of
    ``poisson3d_launch_plan`` for float32 fields), so that each mode is
    the step's kernel with its body stripped."""
    return poisson3d_launch_plan(tuple(shape), torch.float32)


class Poisson3DVariantKernel(_Kernel):
    """Wrapper of the stripped 3-D Poisson apply (csrc/probes.cu
    fluca_poisson3d_variant_f32, instances of csrc/poisson3d.cuh's
    kernel): ``poisson3d_variant(mode, p, coeffs, edges)`` with ``edges``
    = (le1, re1, le2, re2) of ``variant_edge_shapes``; every mode takes
    every input, as the reference's variants do. Launched with
    ``variant_launch_plan``. The ledger keys a launch by (shape, (mode,
    axis-0 periodicity))."""

    name = "poisson3d_variant"
    source = "probes.cu"
    instances = ("f32",)
    argtypes = [_CI, ctypes.POINTER(_VP), _CI, _CI, _CI, _CI, ctypes.POINTER(_CI), _VP]

    def __call__(self, mode, p, c: Poisson3DCoeffs, edges):
        if mode not in VARIANT_MODES:
            raise ValueError(f"{self.name}: unknown mode {mode!r}")
        if not isinstance(p, torch.Tensor) or p.dim() != 3 or tuple(p.shape) != c.shape:
            raise ValueError(f"{self.name}: p must be a 3-D tensor of the coefficients' "
                             f"shape {c.shape}")
        if len(edges) != 4 or any(not isinstance(e, torch.Tensor) or tuple(e.shape) != s
                                  for e, s in zip(edges, variant_edge_shapes(c.shape))):
            raise ValueError(f"{self.name}: edges must be 4 tensors of shapes "
                             f"{variant_edge_shapes(c.shape)}")
        _check_tensors(self.name, p, {"p": p, **dict(zip(("le1", "re1", "le2", "re2"),
                                                         edges))}, {"a0": c.a0})
        if _launch_target(self.name, p) == "cpu":
            return poisson3d_variant_plain(mode, p, c, edges)
        _check_f32(self.name, p)
        N0, N1, N2 = p.shape
        plan = variant_launch_plan(p.shape)
        out = torch.empty_like(p)
        tensors = (p, c.a0, c.c1, c.c2, c.h0, c.h1, c.h2, *edges, out)
        ptrs = (_VP * len(tensors))(*(t.data_ptr() for t in tensors))
        self._launch(torch.float32, ((N0, N1, N2), (mode, c.periodic[0])),
                     VARIANT_MODES[mode], ptrs, N0, N1, N2, int(c.periodic[0]),
                     plan.as_c(), _stream_ptr(p))
        return out


poisson3d_variant = Poisson3DVariantKernel()

KERNELS = (copy_scale, copy_rolls, poisson3d_variant)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()
