"""The halo instances' plain PyTorch versions (the stencil kernels on the
shards of a device grid) against fluca_tpu's sharded wrappers, and the
halo wrappers' CPU behaviour.

Each plain version runs against
- fluca_tpu.parallel.pallas_sharded's wrapper in Pallas interpret mode
  on the 8 virtual CPU devices, at the reference tests' sizes
  (tests/test_pallas_sharded.py:40-215): 32^2 on a (4, 2) grid in 2-D
  (the 2-D momentum kernel also on (2, 4)), 16^3 on (2, 2, 2) for the
  Poisson kernel, (16, 16, 256) on (2, 2, 2) for the 3-D momentum kernel;
  tolerance ||port - ref|| <= 1e-12 * ||ref|| in float64 (the two sum
  the same stencil in another order: ~1e-16; a wrong edge plane or
  coefficient shows at 1e-3 or more);
- the port's unsharded plain version on the same inputs: equal bit for
  bit (the same arithmetic, only the source of the reads differs);
on every periodic/wall combination the reference tests. The JAX
comparisons skip when fewer than 8 devices exist, as the reference's do.
Same inputs for both packages: made with numpy from a seed, the 2-D
plane stack and the 3-D bands built by fluca_tpu and handed to both."""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.ns import tables as JT
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JCond
from fluca_tpu.ns.bc import zero_velocity_bc as j_wall
from fluca_tpu.ns.operators import NSOperators as JOps
from fluca_tpu.ops.pallas_stencil import build_momentum_bands_3d as j_bands
from fluca_tpu.parallel.mesh import make_device_grid as j_grid
from fluca_tpu.parallel.pallas_sharded import (
    build_momentum2d_sharded as j_mom2d,
    build_momentum_sharded as j_mom3d,
    build_poisson_sharded as j_poisson,
)
from fluca_tpu.solvers.mg import PoissonMG as JMG
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TCond
from fluca_tpu_torch.ns.bc import zero_velocity_bc as t_wall
from fluca_tpu_torch.ops import cuda_stencil as cs
from fluca_tpu_torch.parallel.mesh import make_device_grid
from fluca_tpu_torch.parallel.sharded import field_edges, halo_layout
from fluca_tpu_torch.solvers.mg import PoissonMG as TMG

from torch_launch_cover import march2d_cover, march3d_cells, march3d_cover
from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-12
F64 = torch.float64
RHO, MU, DT = 1.3, 0.02, 0.01
MODES = ("apply", "residual", "smooth")


def jax_devices8():
    """The reference's 8 virtual devices, or a skip."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def meshes(N, periodic, stretched):
    faces = [np.linspace(0.0, 1.0, n + 1) for n in N]
    if stretched:
        faces = [f + 0.15 * (f - f**2) for f in faces]
    jm, tm = JMesh.create(N, periodic), TMesh.create(N, periodic)
    jm.set_coordinates(*faces)
    tm.set_coordinates(*faces)
    return jm, tm


def bcs(periodic, BC, Cond, wall):
    out = []
    for per in periodic:
        out += [Cond(BC.PERIODIC) if per else wall()] * 2
    return out


def rel(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    num = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in zip(got, want)))
    return num / np.sqrt(sum(np.sum(w * w) for w in want))


def tt(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def poisson_case(N, periodic):
    """Both packages' finest multigrid level, the port's grid on 8 CPU
    shards, and p, b made with numpy."""
    jm, tm = meshes(N, periodic, stretched=False)
    jlvl = JMG(jm, bcs(periodic, JBC, JCond, j_wall), scale=1.0, dtype=jnp.float64).levels[0]
    tlvl = TMG(tm, bcs(periodic, TBC, TCond, t_wall), scale=1.0, dtype=F64,
               device="cpu").levels[0]
    rng = np.random.default_rng(len(N))
    p, b = (rng.standard_normal(N) for _ in range(2))
    grid = make_device_grid(len(N), ["cpu"] * 8)
    return jlvl, tlvl, grid, p, b


@pytest.mark.parametrize("N, periodic", [
    ((32, 32), (False, False)), ((32, 32), (True, True)), ((32, 32), (True, False)),
    ((16, 16, 16), (True, False, True)), ((16, 16, 16), (False, False, False)),
])
def test_poisson_halo_plain(N, periodic):
    """Every mode of the 2-D and 3-D Poisson halo plain versions: bit
    for bit the unsharded plain version, and fluca_tpu's
    build_poisson_sharded within 1e-12."""
    jlvl, tlvl, grid, p, b = poisson_case(N, periodic)
    layout = halo_layout(grid, tlvl.mesh)
    assert layout.grid.shape == ((4, 2) if len(N) == 2 else (2, 2, 2))
    plain, halo = ((cs.poisson2d_plain, cs.poisson2d_halo_plain) if len(N) == 2
                   else (cs.poisson3d_plain, cs.poisson3d_halo_plain))
    tp, tb = tt(p), tt(b)
    edges = field_edges(layout, tp)
    jgrid = j_grid(len(N), jax_devices8())
    for mode in MODES:
        args = {"apply": (), "residual": (tb,), "smooth": (tb, tlvl.inv_diag)}[mode]
        got = halo(mode, tp, tlvl.coeffs, layout, edges, *args, omega=0.8)
        assert torch.equal(got, plain(mode, tp, tlvl.coeffs, *args, omega=0.8)), mode
        jargs = {"apply": (), "residual": (b,), "smooth": (b, jlvl.inv_diag)}[mode]
        want = j_poisson(jgrid, jlvl, mode=mode, omega=0.8, interpret=True)(
            jnp.asarray(p), *(jnp.asarray(a) for a in jargs))
        assert rel([got], [want]) <= RTOL, mode


def mom2d_inputs(periodic):
    """fluca_tpu's plane stack at random face factors on a non-uniform
    32^2 grid (tests/test_pallas_sharded.py:122-160), and u, v."""
    jm, tm = meshes((32, 32), periodic, stretched=True)
    ops = JOps(jm, bcs(periodic, JBC, JCond, j_wall), rho=RHO, mu=MU, dt=DT,
               dtype=jnp.float64)
    rng = np.random.default_rng(17)
    v = tuple(rng.standard_normal(jm.cell_shape) for _ in range(2))
    U0 = tuple(jnp.asarray(rng.standard_normal(jm.face_shape(d))) for d in range(2))
    v0f = tuple(tuple(jnp.asarray(rng.standard_normal(jm.face_shape(d))) for _ in range(2))
                for d in range(2))
    return jm, tm, np.asarray(ops.build_momentum_coeffs_stacked(U0, v0f)), v


@pytest.mark.parametrize("periodic", [(False, False), (True, False), (True, True)])
def test_momentum2d_halo_plain(periodic):
    """The 2-D momentum halo plain version on (2, 4) and (4, 2): bit for
    bit the unsharded plain version, and fluca_tpu's
    build_momentum2d_sharded within 1e-12."""
    jm, tm, W, v = mom2d_inputs(periodic)
    tW, tv = tt(W), tuple(tt(x) for x in v)
    unsharded = cs.momentum2d_plain(tW, *tv, periodic)
    devices = jax_devices8()
    for shape in ((2, 4), (4, 2)):
        grid = make_device_grid(2, ["cpu"], shape=shape)
        layout = halo_layout(grid, tm)
        got = cs.momentum2d_halo_plain(tW, *tv, layout, *(field_edges(layout, x)
                                                          for x in tv))
        assert all(torch.equal(g, w) for g, w in zip(got, unsharded)), shape
        apply = j_mom2d(j_grid(2, devices, shape=shape), jm, jnp.float64, interpret=True)
        want = jax.jit(apply)(jnp.asarray(W), *(jnp.asarray(x) for x in v))
        assert rel(got, want) <= RTOL, shape


@pytest.mark.parametrize("periodic", [(True, False, True), (False, False, False)])
def test_momentum3d_halo_plain(periodic):
    """The 3-D momentum halo plain version at (16, 16, 256) on (2, 2, 2),
    with the hi face planes of every split axis: bit for bit the
    unsharded plain version, and fluca_tpu's build_momentum_sharded
    within 1e-12, on fluca_tpu's own bands."""
    N = (16, 16, 256)
    jm, tm = meshes(N, periodic, stretched=True)
    axbcs = JT.axis_bcs(jm, bcs(periodic, JBC, JCond, j_wall))
    rng = np.random.default_rng(11)
    v = tuple(rng.standard_normal(N) for _ in range(3))
    U0 = tuple(rng.standard_normal(jm.face_shape(d)) for d in range(3))
    v0f = tuple(tuple(rng.standard_normal(jm.face_shape(d)) for _ in range(3))
                for d in range(3))
    bands = cs.Momentum3DBands.from_host(j_bands(jm, axbcs, RHO, MU, DT), periodic, F64,
                                         "cpu")
    f = cs.Momentum3DFactors.from_faces(tuple(tt(F) for F in U0),
                                        tuple(tuple(tt(F) for F in r) for r in v0f), bands)
    tv = tuple(tt(x) for x in v)
    grid = make_device_grid(3, ["cpu"] * 8)
    layout = halo_layout(grid, tm)
    face_hi = tuple(tuple(F.index_select(a, torch.tensor(
        [(k + 1) * layout.local[a] % F.shape[a] for k in range(2)]))
        for F in (f.U0[a], *f.v0f[a])) for a in range(3))
    got = cs.momentum3d_halo_plain(bands, f, tv, layout,
                                   tuple(field_edges(layout, x) for x in tv), face_hi)
    assert all(torch.equal(g, w) for g, w in zip(got, cs.momentum3d_plain(bands, f, tv)))
    prep, apply = j_mom3d(j_grid(3, jax_devices8()), jm, axbcs, RHO, MU, DT, jnp.float64,
                          interpret=True)
    want = jax.jit(lambda v, U, w: apply(v, prep(U, w)))(
        tuple(jnp.asarray(x) for x in v), tuple(jnp.asarray(F) for F in U0),
        tuple(tuple(jnp.asarray(F) for F in r) for r in v0f))
    assert rel(got, want) <= RTOL


def test_halo_wrappers_on_the_cpu():
    """A CPU tensor takes the plain version and counts no launch; the
    wrappers refuse bf16, misshapen edges, edges on an axis that is not
    split, and a block narrower than 3 on a split axis for the
    momentum kernels."""
    _, tlvl, grid, p, _ = poisson_case((32, 32), (False, True))
    layout = halo_layout(grid, tlvl.mesh)
    tp = tt(p)
    edges = field_edges(layout, tp)
    before = [k.launches for k in cs.KERNELS]
    got = cs.poisson2d_halo("apply", tp, tlvl.coeffs, layout, edges)
    assert torch.equal(got, cs.poisson2d_plain("apply", tp, tlvl.coeffs))
    assert [k.launches for k in cs.KERNELS] == before
    with pytest.raises(ValueError, match="lo edge"):
        cs.poisson2d_halo("apply", tp, tlvl.coeffs, layout,
                          (edges[0], (edges[1][0][:, :1], edges[1][1])))
    one = halo_layout(make_device_grid(2, ["cpu"], shape=(1, 2)), tlvl.mesh)
    with pytest.raises(ValueError, match="not split"):
        cs.poisson2d_halo("apply", tp, tlvl.coeffs, one, edges)
    c16 = cs.Poisson2DCoeffs(*(x.float() for x in (tlvl.coeffs.rx, tlvl.coeffs.ry,
                                                    tlvl.coeffs.cy, tlvl.coeffs.cyb)),
                             tlvl.coeffs.periodic)
    with pytest.raises(TypeError, match="no torch.bfloat16 instance"):
        cs.poisson2d_halo("apply", tp.to(torch.bfloat16), c16, layout,
                          tuple(None if e is None else tuple(t.to(torch.bfloat16) for t in e)
                                for e in edges))

    _, tm, W, v = mom2d_inputs((False, False))
    narrow = make_device_grid(2, ["cpu"], shape=(16, 1))
    layout = halo_layout(narrow, tm)
    tv = tuple(tt(x) for x in v)
    with pytest.raises(ValueError, match="local extent 2"):
        cs.momentum2d_halo(tt(W), *tv, layout, *(field_edges(layout, x) for x in tv))


def test_far_reads_meet_zero_coefficients():
    """The plain version refuses a +-2 plane entry that a halo kernel
    would read past an edge plane as 0: here W[18] (u at i-2) on the
    first row of the second shard along axis 0."""
    _, tm, W, v = mom2d_inputs((False, False))
    grid = make_device_grid(2, ["cpu"], shape=(4, 2))
    layout = halo_layout(grid, tm)
    tW, tv = tt(W), tuple(tt(x) for x in v)
    tW[18, 8, 3] = 1.0
    with pytest.raises(ValueError, match="-2 read past the edge plane of axis 0"):
        cs.momentum2d_halo(tW, *tv, layout, *(field_edges(layout, x) for x in tv))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("N, shape", [((16, 16, 256), (2, 2, 2)), ((10, 14, 66), (2, 2, 2)),
                                      ((12, 10, 70), (2, 1, 2)), ((16, 16, 16), (1, 1, 1)),
                                      ((512, 256, 256), (2, 2, 2))])
def test_momentum3d_halo_launch_plan_covers_every_cell_once(N, shape, dtype):
    """The halo instance launches the plan of the shards' local block
    (momentum3d_launch_plan(layout.local)) once per shard: every cell of
    every block is computed by exactly one thread, so the shards cover
    the grid once; within the card's grid and shared-memory limits."""
    layout = cs.HaloLayout(make_device_grid(3, ["cpu"], shape=shape), N, (True, False, True))
    plan = cs.momentum3d_launch_plan(layout.local, dtype)
    c0, c1, c2 = march3d_cover(plan, layout.local)
    counts = [np.zeros(n, int) for n in N]
    for k in layout.grid.shards():
        for a, c in enumerate((c0, c1, c2)):
            if all(x == 0 for b, x in enumerate(k) if b != a):
                s = layout.start(k)[a]
                counts[a][s:s + layout.local[a]] += c
    assert all(np.all(c == 1) for c in counts)
    if np.prod(layout.local) <= 8 * 8 * 128:
        assert np.all(march3d_cells(plan, layout.local) == 1)
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    assert plan.smem <= cs.MAX_SMEM_BYTES


def test_momentum3d_halo_launch_plan_refuses_what_cannot_fit():
    layout = cs.HaloLayout(make_device_grid(3, ["cpu"], shape=(2, 1, 1)),
                           (10_000_000, 1, 1), (False,) * 3)
    with pytest.raises(ValueError, match="does not fit"):
        cs.momentum3d_launch_plan(layout.local, torch.float32)


# the global grids of the Poisson 3-D halo plan's checks: every multigrid
# level of the 512x256x256 channel down to the coarsest one a (4, 2, 1)
# grid still divides, 128^3, 64x64x32 and 16^3
POISSON3D_HALO_GRIDS = [(512, 256, 256), (256, 128, 128), (128, 64, 64), (64, 32, 32),
                        (32, 16, 16), (16, 8, 8), (128, 128, 128), (64, 64, 32), (16, 16, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2, 1)])
@pytest.mark.parametrize("N", POISSON3D_HALO_GRIDS)
def test_poisson3d_halo_launch_plan_covers_every_cell_once(N, shape, dtype):
    """The Poisson 3-D halo instance launches the plan of the shards'
    local block (poisson3d_launch_plan(layout.local)) once per shard:
    every cell of every block is computed by exactly one thread, so the
    shards cover the grid once; within the card's grid limits, and with
    at least POISSON3D_TARGET_BLOCKS blocks per launch where the block
    has that many tiles and planes."""
    layout = cs.HaloLayout(make_device_grid(3, ["cpu"], shape=shape), N, (True, False, True))
    plan = cs.poisson3d_launch_plan(layout.local, dtype)
    c0, c1, c2 = march3d_cover(plan, layout.local)
    counts = [np.zeros(n, int) for n in N]
    for k in layout.grid.shards():
        for a, c in enumerate((c0, c1, c2)):
            if all(x == 0 for b, x in enumerate(k) if b != a):
                s = layout.start(k)[a]
                counts[a][s:s + layout.local[a]] += c
    assert all(np.all(c == 1) for c in counts)
    if np.prod(layout.local) <= 8 * 8 * 128:
        assert np.all(march3d_cells(plan, layout.local) == 1)
    gx, gy, gz = plan.grid
    assert gy <= 65535 and gz <= 65535
    assert gx * gy * gz >= min(cs.POISSON3D_TARGET_BLOCKS, layout.local[0] * gx * gy)
    assert plan.smem == 4 * dtype.itemsize * plan.run


def test_poisson3d_halo_launch_plan_refuses_what_cannot_fit():
    layout = cs.HaloLayout(make_device_grid(3, ["cpu"], shape=(2, 1, 1)),
                           (2 * (65536 * 8 + 1), 1, 1), (False,) * 3)
    with pytest.raises(ValueError, match="does not fit"):
        cs.poisson3d_launch_plan(layout.local, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 1)])
@pytest.mark.parametrize("N", [(32, 32), (4096, 4096), (256, 256), (64, 32)])
@pytest.mark.parametrize("kernel", ["poisson2d", "momentum2d"])
def test_2d_halo_launch_plan_covers_every_cell_once(kernel, N, shape, dtype):
    """The 2-D halo instances launch the plan of the shards' local block
    (poisson2d_launch_plan / momentum2d_launch_plan(layout.local)) once per
    shard: every cell of every block is computed by exactly one thread, so
    the shards cover the grid once; within the card's grid limits."""
    layout = cs.HaloLayout(make_device_grid(2, ["cpu"], shape=shape), N, (False, True))
    plan_of = getattr(cs, f"{kernel}_launch_plan")
    plan = plan_of(layout.local, dtype)
    c0, c1 = march2d_cover(plan, layout.local, 1 if kernel == "poisson2d" else 2)
    counts = [np.zeros(n, int) for n in N]
    for k in layout.grid.shards():
        for a, c in enumerate((c0, c1)):
            if k[1 - a] == 0:
                s = layout.start(k)[a]
                counts[a][s:s + layout.local[a]] += c
    assert all(np.array_equal(c, np.ones(n)) for c, n in zip(counts, N))
    assert plan.grid[1] <= 65535


def test_2d_halo_wrappers_pass_the_launch_plan():
    """The 2-D halo instances' C entry points take the local block's
    launch plan, as the unsharded ones take the grid's."""
    for k in (cs.poisson2d_halo, cs.momentum2d_halo, cs.poisson2d, cs.momentum2d):
        assert ctypes.POINTER(ctypes.c_int) in k.argtypes, k.name


@pytest.mark.parametrize("N, shape", [((32, 32), (4, 2)), ((32, 32), (1, 1)),
                                      ((16, 16, 16), (2, 2, 2)), ((16, 8, 32), (2, 1, 4))])
def test_halo_shard_offsets_address_each_box(N, shape):
    """The cached per-shard offsets of a halo call (_halo_launch) address
    each shard's first cell in the cell tensors and its element of each
    edge-plane stack, as indexing the tensors does; the geometry array
    carries the local and global extents first; the offsets count as
    aligned where those of the cells and of the axis-0 edge planes (read
    16 bytes at a time) are multiples of 16 bytes."""
    D = len(N)
    layout = cs.HaloLayout(make_device_grid(D, ["cpu"], shape=shape), N, (False,) * D)
    p = torch.zeros(N)
    edges = field_edges(layout, p)
    geom, shards, aligned = cs._halo_launch(layout, p.stride(), p.element_size(),
                                            cs._edge_strides(edges))
    assert list(geom)[:2 * D] == [*layout.local, *N]
    assert len(shards) == len(list(layout.grid.shards()))
    offsets = []
    for k, (start, cell, eoffs) in zip(layout.grid.shards(), shards):
        assert start == layout.start(k)
        assert p.data_ptr() + cell == p[start].data_ptr()
        offsets += [cell] if eoffs[0] is None else [cell, eoffs[0]]
        ptrs = cs._edge_ptrs(cs._edge_bases(edges), eoffs)
        for a, e in enumerate(edges):
            if e is None:
                assert eoffs[a] is None and ptrs[2 * a:2 * a + 2] == [None, None]
                continue
            idx = tuple(k[a] if d == a else i for d, i in enumerate(start))
            assert ptrs[2 * a:2 * a + 2] == [e[0][idx].data_ptr(), e[1][idx].data_ptr()]
    assert aligned == all(x % 16 == 0 for x in offsets)
    # the fields' own edge planes (field_edges) keep the 16-byte reads, even
    # where another axis' planes sit at odd offsets (a (4, 2) grid's axis-1
    # planes are the columns of one (N0, 4) stack)
    assert aligned
