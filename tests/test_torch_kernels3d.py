"""The 3-D CUDA kernels' plain PyTorch versions against fluca_tpu, and
the 3-D wrappers' CPU behaviour: plain version, no launch counted, bad
arguments refused.

The plain Poisson 3-D version is held against fluca_tpu's multigrid on
the CPU (its XLA path: ``_apply_level``, ``_residual``, ``_smooth`` on
every level and one V-cycle), and against the interpret-mode Pallas
kernel; the plain momentum 3-D version against ``NSOperators.apply_A``
(the banded form) and the interpret-mode Pallas kernel. Three boundary
sets: the cavity with a SYMMETRY back plane, the wall-clustered channel
(periodic x and z) and the mixed PRESSURE_OUTLET / SYMMETRY set.

Tolerance: ||plain - reference|| <= 1e-12 * ||reference|| in float64.
The two compute the same stencil from the same float64 tables in
another order of additions (measured ~2e-16); a wrong coefficient,
offset, face factor or boundary read shows at 1e-3 or more."""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.ns import tables as JT
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JCond
from fluca_tpu.ns.bc import zero_velocity_bc as j_wall
from fluca_tpu.ns.operators import NSOperators as JOps
from fluca_tpu.ops.pallas_stencil import (
    build_momentum_apply_3d,
    build_momentum_bands_3d as j_bands,
    build_poisson_apply_3d,
    build_poisson_residual_3d,
    build_poisson_smooth_3d,
)
from fluca_tpu.solvers.mg import PoissonMG as JMG
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.ns import tables as TT
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TCond
from fluca_tpu_torch.ns.bc import zero_velocity_bc as t_wall
from fluca_tpu_torch.ns.operators import NSOperators as TOps
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.solvers.mg import PoissonMG as TMG

from torch_launch_cover import march3d_cells, march3d_cover
from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-12
F64 = torch.float64
RHO, MU, DT = 1.3, 0.02, 0.01

# boundary order left, right, down, up, back, front; p periodic, w
# wall, s symmetry, o pressure outlet
CASES = {
    "cavity-symmetry": ((False,) * 3, "wwwwsw", False),
    "channel-stretched": ((True, False, True), "ppwwpp", True),
    "mixed-outlet": ((False,) * 3, "wowwsw", True),
}


def bcs_of(kinds, BC, Cond, wall):
    table = {"p": Cond(BC.PERIODIC), "w": wall(), "s": Cond(BC.SYMMETRY),
             "o": Cond(BC.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[0])}
    return [table[k] for k in kinds]


def meshes(case, N):
    periodic, _, stretched = CASES[case]
    faces = [np.linspace(0.0, 1.0, n + 1) for n in N]
    if stretched:
        faces = [f + 0.2 * (f - f**2) for f in faces]
    jm, tm = JMesh.create(N, periodic), TMesh.create(N, periodic)
    jm.set_coordinates(*faces)
    tm.set_coordinates(*faces)
    return jm, tm


def pair(case, N):
    """(jax mesh, jax bcs), (torch mesh, torch bcs)."""
    kinds = CASES[case][1]
    jm, tm = meshes(case, N)
    return ((jm, bcs_of(kinds, JBC, JCond, j_wall)),
            (tm, bcs_of(kinds, TBC, TCond, t_wall)))


def rel(got, want):
    want = np.asarray(want)
    return np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)


def mg_pair(case, N=(16, 12, 8)):
    """Both packages' multigrid, coarsened to several levels."""
    (jm, jb), (tm, tb) = pair(case, N)
    return (JMG(jm, jb, scale=0.25, dtype=jnp.float64, coarse_size=32),
            TMG(tm, tb, scale=0.25, dtype=F64, device="cpu", coarse_size=32))


def random_faces(rng, mesh):
    U0 = tuple(rng.standard_normal(mesh.face_shape(d)) for d in range(3))
    v0f = tuple(tuple(rng.standard_normal(mesh.face_shape(d)) for _ in range(3))
                for d in range(3))
    v = tuple(rng.standard_normal(mesh.cell_shape) for _ in range(3))
    return U0, v0f, v


def to_j(tree):
    return tuple(to_j(x) if isinstance(x, tuple) else jnp.asarray(x) for x in tree)


def to_t(tree):
    return tuple(to_t(x) if isinstance(x, tuple) else torch.tensor(x) for x in tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_poisson3d_plain_matches_reference_levels(case):
    jmg, tmg = mg_pair(case)
    assert len(tmg.levels) == len(jmg.levels) >= 2
    rng = np.random.default_rng(5)
    for jl, tl in zip(jmg.levels, tmg.levels):
        p, b = (rng.standard_normal(tl.mesh.cell_shape) for _ in range(2))
        tp, tb = torch.tensor(p), torch.tensor(b)
        jp, jb = jnp.asarray(p), jnp.asarray(b)
        assert rel(cuda_stencil.poisson3d_plain("apply", tp, tl.coeffs),
                   jmg._apply_level(jl, jp)) <= RTOL
        assert rel(cuda_stencil.poisson3d_plain("residual", tp, tl.coeffs, tb),
                   jmg._residual(jl, jp, jb)) <= RTOL
        want = jmg._smooth(jl, jp, jb, 1)
        got = cuda_stencil.poisson3d_plain("smooth", tp, tl.coeffs, tb,
                                           tl.inv_diag, jmg.omega)
        assert rel(got, want) <= RTOL
        # and through the multigrid's own dispatch
        assert rel(tmg._smooth(tl, tp, tb, 2), jmg._smooth(jl, jp, jb, 2)) <= RTOL
    r = rng.standard_normal(tmg.levels[0].mesh.cell_shape)
    assert rel(tmg.precondition(torch.tensor(r)),
               jmg.precondition(jnp.asarray(r))) <= RTOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_poisson3d_plain_matches_pallas(case):
    """The interpret-mode Pallas kernel at an (8, 128)-aligned shape."""
    jmg, tmg = mg_pair(case, N=(8, 16, 128))
    jl, tl = jmg.levels[0], tmg.levels[0]
    rng = np.random.default_rng(6)
    p, b = (rng.standard_normal(tl.mesh.cell_shape) for _ in range(2))
    tp, tb = torch.tensor(p), torch.tensor(b)
    jp, jb = jnp.asarray(p), jnp.asarray(b)
    app = build_poisson_apply_3d(jl, tile_slabs=4, interpret=True)
    res = build_poisson_residual_3d(jl, tile_slabs=4, interpret=True)
    smo = build_poisson_smooth_3d(jl, 0.8, tile_slabs=4, interpret=True)
    assert rel(cuda_stencil.poisson3d("apply", tp, tl.coeffs), app(jp)) <= RTOL
    assert rel(cuda_stencil.poisson3d("residual", tp, tl.coeffs, tb),
               res(jp, jb)) <= RTOL
    assert rel(cuda_stencil.poisson3d("smooth", tp, tl.coeffs, tb, tl.inv_diag, 0.8),
               smo(jp, jb, jl.inv_diag)) <= RTOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_momentum3d_bands_match_reference(case):
    (jm, jb), (tm, tb) = pair(case, (8, 12, 10))
    want = j_bands(jm, JT.axis_bcs(jm, jb), RHO, MU, DT)
    got = cuda_stencil.build_momentum_bands_3d(tm, TT.axis_bcs(tm, tb), RHO, MU, DT)
    for g, w in zip(got, want):
        assert g.shape == (cuda_stencil.MOMENTUM3D_ROWS, w.shape[1])
        assert np.array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_momentum3d_plain_matches_reference(case):
    """An unaligned 8x12x10 grid, random factors and v."""
    (jm, jb), (tm, tb) = pair(case, (8, 12, 10))
    jo = JOps(jm, jb, rho=RHO, mu=MU, dt=DT, dtype=jnp.float64)
    to = TOps(tm, tb, RHO, MU, DT, F64, "cpu")
    U0, v0f, v = random_faces(np.random.default_rng(11), tm)
    want = jo.apply_A(to_j(v), to_j(U0), to_j(v0f))
    f = to.build_momentum_factors_3d(to_t(U0), to_t(v0f))
    got = cuda_stencil.momentum3d_plain(to.mom_bands3d, f, to_t(v))
    via_ops = to.apply_A_coeffs(to_t(v), f)
    for c in range(3):
        assert rel(got[c], want[c]) <= RTOL
        assert torch.equal(via_ops[c], got[c])
    # the identity row: A 1 - 1 is the row sum of dt C - (mu dt/2rho) L
    ones = tuple(torch.ones(tm.cell_shape, dtype=F64) for _ in range(3))
    jones = tuple(jnp.ones(tm.cell_shape) for _ in range(3))
    rs, jrs = to.apply_A_coeffs(ones, f), jo.apply_A(jones, to_j(U0), to_j(v0f))
    for c in range(3):
        assert rel(rs[c], jrs[c]) <= RTOL


def test_momentum3d_plain_matches_pallas():
    """The interpret-mode Pallas kernel on the channel, at the cross-
    section of tests/test_momentum_kernel3d.py with one 8-plane tile
    along axis 0, which keeps the interpret-mode run short."""
    (jm, jb), (tm, tb) = pair("channel-stretched", (8, 16, 128))
    to = TOps(tm, tb, RHO, MU, DT, F64, "cpu")
    prep, apply = build_momentum_apply_3d(
        jm, JT.axis_bcs(jm, jb), RHO, MU, DT, jnp.float64, interpret=True)
    U0, v0f, v = random_faces(np.random.default_rng(12), tm)
    want = apply(to_j(v), prep(to_j(U0), to_j(v0f)))
    got = cuda_stencil.momentum3d(
        to.mom_bands3d, to.build_momentum_factors_3d(to_t(U0), to_t(v0f)), to_t(v))
    for c in range(3):
        assert rel(got[c], want[c]) <= RTOL


def test_poisson3d_coeffs_match_reference_planes():
    """The 1-D arrays give the reference's separable planes:
    W1 = C1 x H2, W2 = H1 x C2, H12 = H1 x H2, and the same A0, H0."""
    from fluca_tpu.ops.pallas_stencil import poisson3d_coeffs as j_coeffs

    jmg, tmg = mg_pair("channel-stretched")
    for jl, tl in zip(jmg.levels, tmg.levels):
        A0, W1, W2 = (np.asarray(x) for x in (j_coeffs(jl)[0], j_coeffs(jl)[2],
                                              j_coeffs(jl)[3]))
        H0, H12 = j_coeffs(jl)[1], j_coeffs(jl)[4]
        a0, c1, c2, h0, h1, h2 = cuda_stencil.poisson3d_coeffs(
            tl.mesh, tl.host_dgst, tl.host_vol)
        np.testing.assert_allclose(a0, A0, rtol=RTOL, atol=0)
        np.testing.assert_allclose(h0, H0, rtol=RTOL, atol=0)
        np.testing.assert_allclose(c1[:, :, None] * h2[None, None, :], W1,
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(h1[None, :, None] * c2[:, None, :], W2,
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(h1[:, None] * h2[None, :], H12, rtol=RTOL, atol=0)


def test_cpu_3d_wrappers_take_plain_versions_and_count_nothing():
    _, tmg = mg_pair("cavity-symmetry")
    lvl = tmg.levels[0]
    (_, _), (tm, tb) = pair("mixed-outlet", (4, 6, 5))
    to = TOps(tm, tb, RHO, MU, DT, F64, "cpu")
    U0, v0f, v = random_faces(np.random.default_rng(1), tm)
    f = to.build_momentum_factors_3d(to_t(U0), to_t(v0f))
    p = torch.randn(lvl.mesh.cell_shape, dtype=F64)
    before = [k.launches for k in cuda_stencil.KERNELS]
    assert torch.equal(cuda_stencil.poisson3d("residual", p, lvl.coeffs, p),
                       cuda_stencil.poisson3d_plain("residual", p, lvl.coeffs, p))
    got = cuda_stencil.momentum3d(to.mom_bands3d, f, to_t(v))
    want = cuda_stencil.momentum3d_plain(to.mom_bands3d, f, to_t(v))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [k.launches for k in cuda_stencil.KERNELS] == before
    assert cuda_stencil.KERNELS[2:4] == (cuda_stencil.poisson3d, cuda_stencil.momentum3d)


def test_3d_wrappers_refuse_bad_arguments():
    _, tmg = mg_pair("cavity-symmetry")
    c = tmg.levels[0].coeffs
    shape = tmg.levels[0].mesh.cell_shape
    p = torch.zeros(shape, dtype=F64)
    with pytest.raises(ValueError):  # a 2-D field
        cuda_stencil.poisson3d("apply", torch.zeros(shape[:2], dtype=F64), c)
    with pytest.raises(ValueError):  # another grid
        cuda_stencil.poisson3d("apply", torch.zeros((2, 2, 2), dtype=F64), c)
    with pytest.raises(TypeError):  # dtype differs from the coefficients'
        cuda_stencil.poisson3d("apply", p.float(), c)
    with pytest.raises(ValueError):  # not contiguous
        cuda_stencil.poisson3d("apply", p.transpose(0, 2).contiguous().transpose(0, 2),
                               c)
    with pytest.raises(ValueError):  # smooth needs w
        cuda_stencil.poisson3d("smooth", p, c, p)
    with pytest.raises(ValueError):  # coefficient arrays that disagree
        cuda_stencil.Poisson3DCoeffs(c.a0, c.c1, c.c2, c.h0, c.h1[:-1], c.h2,
                                     c.periodic)

    (_, _), (tm, tb) = pair("channel-stretched", (4, 6, 5))
    to = TOps(tm, tb, RHO, MU, DT, F64, "cpu")
    U0, v0f, v = random_faces(np.random.default_rng(2), tm)
    with pytest.raises(ValueError):  # a face array of cell shape on a wall axis
        to.build_momentum_factors_3d(
            to_t(U0), (to_t(v0f[0]), to_t(tuple(v[:3])), to_t(v0f[2])))
    with pytest.raises(ValueError):  # U0 short of an axis
        to.build_momentum_factors_3d(to_t(U0[:2]), to_t(v0f))
    f = to.build_momentum_factors_3d(to_t(U0), to_t(v0f))
    with pytest.raises(ValueError):  # built directly, a wall axis with N faces
        cuda_stencil.Momentum3DFactors(f.U0, (f.v0f[0], f.U0, f.v0f[2]), f.shape,
                                       f.periodic)
    with pytest.raises(TypeError):  # built directly, one face in another dtype
        cuda_stencil.Momentum3DFactors((f.U0[0].float(), *f.U0[1:]), f.v0f,
                                       f.shape, f.periodic)
    walls = (False, False, False)
    faces = [torch.zeros(cuda_stencil._face_shape(f.shape, walls, a), dtype=F64)
             for a in range(3)]
    with pytest.raises(ValueError):  # factors of another periodicity
        cuda_stencil.momentum3d(to.mom_bands3d, cuda_stencil.Momentum3DFactors(
            tuple(faces), tuple((F,) * 3 for F in faces), f.shape, walls), to_t(v))
    with pytest.raises(ValueError):  # v of another shape
        cuda_stencil.momentum3d(to.mom_bands3d, f,
                                tuple(torch.zeros((4, 6, 6), dtype=F64)
                                      for _ in range(3)))
    with pytest.raises(ValueError):  # two components
        cuda_stencil.momentum3d(to.mom_bands3d, f, to_t(v[:2]))
    with pytest.raises(TypeError):  # v in another dtype
        cuda_stencil.momentum3d(to.mom_bands3d, f,
                                tuple(x.float() for x in to_t(v)))
    with pytest.raises(ValueError):  # factors of another grid
        other = TOps(*pair("channel-stretched", (4, 6, 6))[1], RHO, MU, DT, F64,
                     "cpu")
        cuda_stencil.momentum3d(other.mom_bands3d, f, to_t(v))
    with pytest.raises(ValueError):  # the 2-D stack does not exist in 3-D
        to.build_momentum_coeffs_stacked(to_t(U0), to_t(v0f))


# ----------------------------------------------------------------------
# the momentum 3-D kernel's launch plan (csrc/momentum3d.cu)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, F64, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 7, 33), (8, 8, 8), (16, 16, 256), (1, 1, 1),
                                   (128, 128, 128), (512, 256, 256)])
def test_momentum3d_launch_plan_covers_every_cell_once(shape, dtype):
    """Every cell is computed by exactly one thread, the grid is within
    the card's limits and the shared memory within a block's 227 KB;
    thread by thread up to 16^2 x 256 cells, by the per-axis maps (whose
    product is the kernel's map) at every size."""
    plan = cuda_stencil.momentum3d_launch_plan(shape, dtype)
    assert all(np.all(c == 1) for c in march3d_cover(plan, shape))
    if np.prod(shape) <= 16 * 16 * 256:
        assert np.all(march3d_cells(plan, shape) == 1)
    gx, gy, gz = plan.grid
    assert gx < 2**31 and gy <= 65535 and gz <= 65535
    assert 32 * plan.rows <= 256
    assert plan.smem == (cuda_stencil.coef_dtype(dtype).itemsize * 28
                         * (plan.run + plan.rows + 32) + 4 * plan.run)
    assert plan.smem <= cuda_stencil.MAX_SMEM_BYTES
    assert list(plan.as_c()) == [*plan.grid, plan.rows, plan.run, plan.smem]


@pytest.mark.parametrize("shape, run", [((512, 256, 256), 32), ((128, 128, 128), 16),
                                        ((256, 128, 128), 16), ((7, 9, 40), 7)])
def test_momentum3d_launch_plan_runs(shape, run):
    """The runs: 32 planes at 512x256x256, 16 at 128^3 and at a (2, 2, 2)
    shard of 512x256x256 (the lengths the H100 ran fastest), the whole
    axis where it is shorter; >= 4 blocks per SM of the H100's 132 at the
    channel sizes."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = cuda_stencil.momentum3d_launch_plan(shape, dtype)
        assert (plan.rows, plan.run) == (4, run)
        if shape[0] >= 128:
            assert np.prod(plan.grid) >= 4 * 132


@pytest.mark.parametrize("shape", [(5_000_000, 1, 1),       # more runs than the grid's z extent
                                   (1, 65535 * 4 + 1, 1),   # more row tiles than its y extent
                                   (4, 4, 0), (4, 4)])
def test_momentum3d_launch_plan_refuses_what_cannot_fit(shape):
    with pytest.raises(ValueError):
        cuda_stencil.momentum3d_launch_plan(shape, torch.float32)


# ----------------------------------------------------------------------
# the Poisson 3-D kernel's launch plan (csrc/poisson3d.cu)
# ----------------------------------------------------------------------

# every multigrid level of the 512x256x256 channel (the coarse one
# included), and the other 3-D shapes of the port's runs and checks
POISSON3D_SHAPES = [(512, 256, 256), (256, 128, 128), (128, 64, 64), (64, 32, 32),
                    (32, 16, 16), (16, 8, 8), (128, 128, 128), (64, 64, 32), (37, 29, 33),
                    (16, 16, 16), (1, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, F64, torch.bfloat16])
@pytest.mark.parametrize("shape", POISSON3D_SHAPES)
def test_poisson3d_launch_plan_covers_every_cell_once(shape, dtype):
    """Every cell is computed by exactly one thread (thread by thread up
    to 16^2 x 256 cells, by the per-axis maps at every size), within the
    card's grid, block and shared-memory limits; the shared memory holds
    the run's 4 axis-0 values per plane."""
    plan = cuda_stencil.poisson3d_launch_plan(shape, dtype)
    assert all(np.all(c == 1) for c in march3d_cover(plan, shape))
    if np.prod(shape) <= 16 * 16 * 256:
        assert np.all(march3d_cells(plan, shape) == 1)
    gx, gy, gz = plan.grid
    assert gx < 2**31 and gy <= 65535 and gz <= 65535
    assert 32 * plan.rows <= 512
    assert plan.smem == 4 * cuda_stencil.coef_dtype(dtype).itemsize * plan.run
    assert list(plan.as_c()) == [*plan.grid, plan.rows, plan.run, plan.smem]


@pytest.mark.parametrize("shape", POISSON3D_SHAPES)
def test_poisson3d_launch_plan_fills_the_card(shape):
    """At least POISSON3D_TARGET_BLOCKS blocks (about 8 per SM of the
    H100's 132) where the shape has that many (rows x 32) tiles and
    planes, else one plane per block; runs of at most 8 planes: 8 on the
    two finest levels of the 512x256x256 channel and 4 on the third, the
    runs its smooth was fastest at on the H100."""
    plan = cuda_stencil.poisson3d_launch_plan(shape, torch.float32)
    gx, gy, gz = plan.grid
    units = shape[0] * gx * gy
    target = cuda_stencil.POISSON3D_TARGET_BLOCKS
    assert target >= 7 * 132
    assert gx * gy * gz >= min(target, units)
    assert gx * gy * gz >= min(132, units)
    assert plan.run <= cuda_stencil.POISSON3D_RUNS[1]
    if units < 2 * target:
        assert plan.run == 1
    runs = {(512, 256, 256): 8, (256, 128, 128): 8, (128, 64, 64): 4}
    if shape in runs:
        assert (plan.rows, plan.run) == (4, runs[shape])


@pytest.mark.parametrize("shape", [(1, 65535 * 4 + 1, 1),       # more row tiles than the grid's y extent
                                   (65536 * 8 + 1, 1, 1),       # more runs than its z extent
                                   (4, 4, 0), (4, 4)])
def test_poisson3d_launch_plan_refuses_what_cannot_fit(shape):
    with pytest.raises(ValueError):
        cuda_stencil.poisson3d_launch_plan(shape, torch.float32)


def test_poisson3d_source_exports_every_instance():
    """csrc/poisson3d.cu exports one C entry point per instance of the
    unsharded and the halo wrappers, each taking the launch plan; the
    instances are one kernel template, in poisson3d.cuh (which probes.cu's
    stripped variants instantiate too)."""
    src = (cuda_stencil.CSRC_DIR / "poisson3d.cu").read_text()
    template = (cuda_stencil.CSRC_DIR / "poisson3d.cuh").read_text()
    exported = set(re.findall(r'^\s*extern "C" int fluca_(\w+)##SFX\(', src, re.M))
    instances = set(re.findall(r"^FLUCA_POISSON3D(_HALO)?_EXPORT\((\w+),", src, re.M))
    names = {f"poisson3d{'_halo' if halo else ''}_{sfx}" for halo, sfx in instances}
    kernels = (cuda_stencil.poisson3d, cuda_stencil.poisson3d_halo)
    assert exported == {"poisson3d_", "poisson3d_halo_"}
    assert names == {f"{k.name}_{sfx}" for k in kernels for sfx in k.instances}
    assert {k.source for k in kernels} == {"poisson3d.cu"}
    assert "poisson3d.cu" in cuda_stencil.SOURCES
    assert all(ctypes.POINTER(ctypes.c_int) in k.argtypes for k in kernels)
    assert '#include "poisson3d.cuh"' in src and "poisson3d.cuh" in cuda_stencil.HEADERS
    assert len(re.findall(r"__global__", src)) == 0
    assert len(re.findall(r"__global__", template)) == 1
    assert "load3d" not in src + template
