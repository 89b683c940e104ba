"""The probe kernels' plain PyTorch versions (fluca_tpu_torch/ops/probes.py)
against the repo's own probe ``pallas_call`` s, and the wrappers' CPU
behaviour.

The reference's probe kernels run here in Pallas TPU interpret mode: a
probe's ``pallas_call`` is built and called inside
``pltpu.force_tpu_interpret_mode()`` (built outside it, the call raises
"Only interpret mode is supported on CPU backend"). The example scripts
are not a package, so they are imported by path. Inputs are made with
numpy from a seed and handed to both. Tolerances:
- the copies, float32: max abs difference 0 (one product by the same
  float32 factor; the copy with rolls adds the same float32 terms in the
  same order);
- the stripped Poisson variants, float64: ||port - ref|| <= 1e-12 ||ref||
  (the port sums H1 H2 s0 + H0 (H2 s1 + H1 s2) from 1-D arrays, the
  reference (s0) H12 + H0 (W1 sum + W2 sum) from precomputed planes: the
  same terms, rounded in another order, ~1e-16 apart; a wrong edge, shift
  or coefficient shows at 1e-3 or more); max abs 0 for ``nocomp``.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fluca_tpu.ops.pallas_stencil import _roll, poisson3d_tile_edges
from fluca_tpu_torch.ops import cuda_stencil, probes

from torch_launch_cover import copy_cover
from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12
F32, F64 = torch.float32, torch.float64


def example(name):
    """The repo's ``examples/<name>.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(f"examples_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ----------------------------------------------------------------------
# copy_scale
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,tm", [((16, 8, 128), 8), ((32, 128), 8), ((24, 8, 128), 4)])
def test_copy_scale_plain_matches_copy_call(shape, tm):
    """One and two pairs against examples/probe512split.py copy_call
    (:50), the copy of every probe."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        call = example("probe512split").copy_call(shape, jnp.float32, tm)
        ra, rb = (np.asarray(call(jnp.asarray(x))) for x in (a, b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = probes.copy_scale_plain(ta)
    assert got.dtype == F32 and np.abs(got.numpy() - ra).max() == 0
    ga, gb = probes.copy_scale_plain(ta, tb)
    assert np.abs(ga.numpy() - ra).max() == 0 and np.abs(gb.numpy() - rb).max() == 0
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(probes.copy_scale(ta, rows=tm), got)
    wa, wb = probes.copy_scale(ta, tb, rows=tm)
    assert torch.equal(wa, ga) and torch.equal(wb, gb)


# ----------------------------------------------------------------------
# copy_rolls
# ----------------------------------------------------------------------

def rolls_call(shape, tm, factor):
    """The copy + two in-plane rolls of examples/profile512.py:277-285
    (that body, written out, with its 1e-20 as ``factor``), built for
    interpret mode."""
    N0, N1, N2 = shape

    def k(a, o):
        acc = a[...] * 1.0000001
        for s in range(tm):
            p = a[s]
            r1 = _roll(p, 1, 0)
            r2 = _roll(p, 1, 1)
            acc = acc.at[s].add(factor * (r1 + r2))
        o[...] = acc

    spec = pl.BlockSpec((tm, N1, N2), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                          grid=(N0 // tm,), in_specs=[spec], out_specs=spec)


@pytest.mark.parametrize("tm", [8, 4])
def test_copy_rolls_plain_matches_profile512_body(tm):
    shape = (16, 8, 128)
    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape).astype(np.float32)
    # a spike whose 1e-20 share is visible: its two roll neighbours
    # (the next row and the next column, wrapping) read ~1 there
    a[3, 7, 127] = 1e20
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(rolls_call(shape, tm, 1e-20)(jnp.asarray(a)))
        unscaled = np.asarray(rolls_call(shape, tm, 1.0)(jnp.asarray(a)))
    ta = torch.from_numpy(a)
    got = probes.copy_rolls_plain(ta)
    assert np.abs(got.numpy() - ref).max() == 0
    # the rolls wrap forward: the spike shows at the next row and column
    added = (got - ta * probes.SCALE).abs() > 0.5
    assert added.nonzero().tolist() == [[3, 0, 127], [3, 7, 0]]
    assert torch.equal(probes.copy_rolls(ta, rows=tm), got)
    # roll's direction with the factor 1: torch.roll(a, 1, axis) reads
    # a[q - 1] as pltpu.roll does
    want = ta * probes.SCALE + (torch.roll(ta, 1, 1) + torch.roll(ta, 1, 2))
    assert np.abs(want.numpy() - unscaled).max() == 0


# ----------------------------------------------------------------------
# poisson3d_variant
# ----------------------------------------------------------------------

def reference_body(TM, N1, N2, noroll):
    """``full_body`` of examples/probe_poisson512.py:159-183, written out
    (in the script it is a closure of main)."""
    def body(s, base, block, a0t, h0t, w1r, w2r, h12r, ue, de, le1, re1, le2, re2):
        rows = jax.lax.broadcasted_iota(jnp.int32, (N1, N2), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (N1, N2), 1)
        p = block[s]
        up = ue[0] if s == 0 else block[s - 1]
        dn = de[0] if s == TM - 1 else block[s + 1]
        c0m = a0t[0, base + s]
        c00 = a0t[1, base + s]
        c0p = a0t[2, base + s]
        term0 = (c0m * up + c00 * p + c0p * dn) * h12r[...]
        if noroll:
            left = right = fwd = bwd = p
        else:
            left = _roll(p, 1, 0)
            right = _roll(p, N1 - 1, 0)
            fwd = _roll(p, 1, 1)
            bwd = _roll(p, N2 - 1, 1)
        left = jnp.where(rows == 0, le1[s], left)
        right = jnp.where(rows == N1 - 1, re1[s], right)
        term1 = w1r[0] * left + w1r[1] * p + w1r[2] * right
        fwd = jnp.where(cols == 0, le2[s], fwd)
        bwd = jnp.where(cols == N2 - 1, re2[s], bwd)
        term2 = w2r[0] * fwd + w2r[1] * p + w2r[2] * bwd
        return term0 + h0t[base + s] * (term1 + term2)

    return body


def nocomp_body(s, base, block, *rest):
    """The ``stencil_nocomp`` body (probe_poisson512.py:203-206)."""
    return block[s] * 1.0000001


def random_coeffs(rng, shape, periodic):
    """Random 1-D arrays of a Poisson3DCoeffs (float64, CPU), and the
    reference's A0, H0, W1, W2, H12 built from them as
    pallas_stencil.poisson3d_coeffs builds its planes."""
    N0, N1, N2 = shape
    a0, c1, c2 = (rng.standard_normal((3, n)) for n in shape)
    h0, h1, h2 = (0.5 + rng.random(n) for n in shape)
    W1 = np.stack([c1[o][:, None] * h2[None, :] for o in range(3)])
    W2 = np.stack([h1[:, None] * c2[o][None, :] for o in range(3)])
    H12 = h1[:, None] * h2[None, :]
    c = cuda_stencil.Poisson3DCoeffs.from_host((a0, c1, c2, h0, h1, h2), periodic, F64, "cpu")
    return c, (a0, h0, W1, W2, H12)


@pytest.mark.parametrize("mode", ["rebuilt", "noroll", "nocomp"])
def test_variant_plain_matches_variant_call(mode):
    shape = (16, 8, 128)
    N0, N1, N2 = shape
    rng = np.random.default_rng(2)
    c, (A0, H0, W1, W2, H12) = random_coeffs(rng, shape, (True, False, True))
    x = rng.standard_normal(shape)
    edges = [rng.standard_normal(s) for s in probes.variant_edge_shapes(shape)]
    body = nocomp_body if mode == "nocomp" else reference_body(8, N1, N2, mode == "noroll")
    with pltpu.force_tpu_interpret_mode():
        call, TM, ntiles = example("probe_poisson512").variant_call(N0, N1, N2, jnp.float64,
                                                                    body)
        xj = jnp.asarray(x)
        ue, de = poisson3d_tile_edges(xj, TM, ntiles, True, jnp.float64)
        ref = np.asarray(call(*(jnp.asarray(t) for t in (A0, H0)), xj,
                              *(jnp.asarray(t) for t in (W1, W2, H12)), ue, de,
                              *(jnp.asarray(e) for e in edges)))
    got = probes.poisson3d_variant_plain(mode, torch.from_numpy(x), c,
                                         tuple(torch.from_numpy(e) for e in edges))
    if mode == "nocomp":
        assert np.abs(got.numpy() - ref).max() == 0
    else:
        assert rel(got, ref) <= RTOL
    wrapped = probes.poisson3d_variant(mode, torch.from_numpy(x), c,
                                       tuple(torch.from_numpy(e) for e in edges))
    assert torch.equal(wrapped, got)


def true_edges(p, periodic):
    """The in-plane edges that make ``rebuilt`` the apply: the wrapped
    rows and columns on a periodic axis, zeros at a wall."""
    def edge(a, idx):
        e = p.narrow(a, idx, 1)
        return e.clone() if periodic[a] else torch.zeros_like(e)

    N1, N2 = p.shape[1:]
    return edge(1, N1 - 1), edge(1, 0), edge(2, N2 - 1), edge(2, 0)


@pytest.mark.parametrize("periodic", [(True, False, True), (False, True, False),
                                      (True, True, True), (False, False, False)])
def test_variant_rebuilt_with_true_edges_is_the_apply(periodic):
    rng = np.random.default_rng(3)
    shape = (12, 6, 10)
    c, _ = random_coeffs(rng, shape, periodic)
    p = torch.from_numpy(rng.standard_normal(shape))
    got = probes.poisson3d_variant_plain("rebuilt", p, c, true_edges(p, periodic))
    assert torch.equal(got, cuda_stencil.poisson3d_plain("apply", p, c))
    # the zero edges of the probe differ from the apply on a periodic axis
    zeros = tuple(torch.zeros(s, dtype=F64) for s in probes.variant_edge_shapes(shape))
    zero_edged = probes.poisson3d_variant_plain("rebuilt", p, c, zeros)
    assert torch.equal(zero_edged, got) == (not (periodic[1] or periodic[2]))


@pytest.mark.parametrize("shape", [(512, 256, 256), (256, 256, 256), (128, 128, 128),
                                   (12, 6, 10)])
def test_variant_launches_with_the_apply_plan(shape):
    """The stripped variants launch with the grid, block rows, run and
    shared memory that the Poisson 3-D apply takes at the shape, and the
    source builds them from the apply's kernel template (no kernel of
    their own)."""
    plan = probes.variant_launch_plan(shape)
    assert plan == cuda_stencil.poisson3d_launch_plan(shape, torch.float32)
    assert ctypes.POINTER(ctypes.c_int) in probes.poisson3d_variant.argtypes
    src = (cuda_stencil.CSRC_DIR / "probes.cu").read_text()
    assert '#include "poisson3d.cuh"' in src
    assert "poisson3d_variant_kernel" not in src and "load3d" not in src
    for strip in ("kRebuilt", "kNoRoll", "kNoComp"):
        assert f"case {strip}:" in src
    assert [probes.VARIANT_MODES[m] for m in ("rebuilt", "noroll", "nocomp")] == [0, 1, 2]


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------

def test_probe_wrappers_refuse_bad_arguments():
    a = torch.zeros((8, 4, 4))
    c, _ = random_coeffs(np.random.default_rng(4), (8, 4, 4), (True, False, True))
    edges64 = tuple(torch.zeros(s, dtype=F64) for s in probes.variant_edge_shapes((8, 4, 4)))
    with pytest.raises(ValueError):  # three pairs
        probes.copy_scale(a, a, a, rows=8)
    with pytest.raises(ValueError):  # two shapes
        probes.copy_scale(a, torch.zeros((8, 4, 5)), rows=8)
    with pytest.raises(TypeError):  # two dtypes
        probes.copy_scale(a, a.double(), rows=8)
    with pytest.raises(ValueError):  # rank 1
        probes.copy_scale(torch.zeros(8), rows=8)
    with pytest.raises(ValueError):  # rows
        probes.copy_scale(a, rows=0)
    with pytest.raises(ValueError):  # not contiguous
        probes.copy_scale(torch.zeros((4, 8, 4)).transpose(0, 1), rows=8)
    with pytest.raises(ValueError):  # copy_rolls takes 3-D fields
        probes.copy_rolls(torch.zeros((8, 4)), rows=8)
    with pytest.raises(ValueError):  # unknown mode
        probes.poisson3d_variant("full", a.double(), c, edges64)
    with pytest.raises(ValueError):  # edges of another shape
        probes.poisson3d_variant("rebuilt", a.double(), c, edges64[:2] + edges64[:2])
    with pytest.raises(TypeError):  # field in another dtype than the coefficients
        probes.poisson3d_variant("rebuilt", a, c, edges64)


def test_probe_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor off the CPU launches its kernel or raises: on the meta
    device (no kernel) every wrapper raises, and no launch is counted."""
    meta = torch.empty((8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        probes.copy_scale(meta, rows=8)
    with pytest.raises(ValueError, match="no kernel"):
        probes.copy_rolls(meta, rows=8)
    assert [k.launches for k in probes.KERNELS] == [0, 0, 0]


def test_probes_source_exports_every_instance():
    """csrc/probes.cu exports one C entry point per wrapper instance,
    and is built into the kernel library."""
    src = (cuda_stencil.CSRC_DIR / "probes.cu").read_text()
    exported = set(re.findall(r'^extern "C" int fluca_(\w+)\(', src, re.M))
    assert exported == {f"{k.name}_{sfx}" for k in probes.KERNELS for sfx in k.instances}
    assert {k.source for k in probes.KERNELS} == {"probes.cu"}
    assert "probes.cu" in cuda_stencil.SOURCES
    assert "--use_fast_math" not in cuda_stencil.NVCC_FLAGS


# every (shape, rows) at which bench.py and the probes launch the copy:
# probe512's sweep, spmv_roofline (4096^2, 128), poisson3d_roofline and
# probe512split (256^3, 8), probe_poisson512 (512x256x256, 8), and
# profile512's TM 8 and 4 at the 512 channel and at the smoke's 128^3
COPY_LAUNCHES = [((512, 256, 256), 8), ((512, 256, 256), 16), ((256, 256, 256), 8),
                 ((8192, 4096), 256), ((16384, 4096), 256), ((4096, 4096), 128),
                 ((512, 256, 256), 4), ((128, 128, 128), 8), ((128, 128, 128), 4)]


@pytest.mark.parametrize("shape, rows, vec", [
    *((shape, rows, vec) for shape, rows in COPY_LAUNCHES for vec in (4, 1)),
    ((37, 12, 8), 8, 4), ((33, 7), 4, 1), ((300, 8), 256, 4), ((5, 3), 16, 1)])
def test_copy_scale_plan_covers_every_element_once(shape, rows, vec):
    """Every (row, column) of the field is copied by exactly one thread,
    within the grid; at the path's own shapes the launch keeps >= 32 KB
    of loads in flight per SM of the H100 (132 SMs)."""
    R, C = shape[0], int(np.prod(shape[1:]))
    plan = probes.copy_scale_plan(shape, rows, vec)
    by_row, by_col = copy_cover(plan, R, C // vec)
    assert np.all(by_row == 1) and np.all(by_col == 1)
    assert plan.grid[1] <= 65535 and plan.threads * plan.groups <= 1024
    assert plan.threads % 32 == 0 and plan.unroll in (2, 4) and plan.groups <= rows
    if (shape, rows) in COPY_LAUNCHES and vec == 4:
        threads = plan.grid[0] * plan.grid[1] * plan.threads * plan.groups
        in_flight = threads * min(plan.unroll, -(-rows // plan.groups)) * 4 * vec
        assert in_flight / 132 >= 32 * 1024


def test_copy_scale_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError):  # more row blocks than the grid's y extent
        probes.copy_scale_plan((65536 * 2, 4), 1, 4)
    with pytest.raises(ValueError):  # rows of 6 floats in float4
        probes.copy_scale_plan((8, 6), 8, 4)
    with pytest.raises(ValueError):
        probes.copy_scale_plan((8, 4), 0, 4)
