"""The CUDA kernels' plain PyTorch versions against fluca_tpu's Pallas
kernels in interpret mode (as tests/test_pallas.py and
tests/test_momentum_kernel.py run them), and the wrappers' CPU
behaviour: plain version, no launch counted, bad arguments refused.

Tolerance: ||plain - pallas|| <= 1e-12 * ||pallas|| in float64. The
two compute the same separable stencil from the same float64
coefficients in another order of additions (unit roundoff 1.1e-16);
a wrong coefficient, offset or boundary read shows at 1e-3 or more."""

import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.models.tgv import setup_taylor_green_2d as j_tgv
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JCond
from fluca_tpu.ns.bc import zero_velocity_bc as j_wall
from fluca_tpu.ops.pallas_stencil import (
    build_momentum_apply_2d,
    build_poisson_apply_2d,
    build_poisson_residual_2d,
    build_poisson_smooth_2d,
)
from fluca_tpu.solvers.mg import PoissonMG as JMG
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.models.tgv import setup_taylor_green_2d as t_tgv
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TCond
from fluca_tpu_torch.ns.bc import zero_velocity_bc as t_wall
from fluca_tpu_torch.ns.ns import NS
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.solvers.mg import PoissonMG as TMG

from torch_launch_cover import march2d_cover
from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-12
F64 = torch.float64


def rel(got, want):
    want = np.asarray(want)
    return np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)


def mg_pair(periodic, N=(64, 32), stretched=False):
    f = [np.linspace(0.0, 1.0, n + 1) ** (1.3 if stretched else 1.0) for n in N]
    jm = JMesh.create(N, (periodic,) * 2)
    tm = TMesh.create(N, (periodic,) * 2)
    jm.set_coordinates(*f)
    tm.set_coordinates(*f)
    if periodic:
        jb, tb = JCond(JBC.PERIODIC), TCond(TBC.PERIODIC)
    else:
        jb, tb = j_wall(), t_wall()
    return (JMG(jm, [jb] * 4, scale=0.25, dtype=jnp.float64),
            TMG(tm, [tb] * 4, scale=0.25, dtype=F64, device="cpu"))


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_poisson2d_plain_matches_pallas(periodic, stretched):
    jmg, tmg = mg_pair(periodic, stretched=stretched)
    jl, tl = jmg.levels[0], tmg.levels[0]
    rng = np.random.default_rng(3)
    p, b = (rng.standard_normal(tl.mesh.cell_shape) for _ in range(2))
    tp, tb = torch.tensor(p), torch.tensor(b)
    jp, jb = jnp.asarray(p), jnp.asarray(b)
    w = tl.inv_diag

    app = build_poisson_apply_2d(jl, tile_rows=16, interpret=True)
    res = build_poisson_residual_2d(jl, tile_rows=16, interpret=True)
    smo = build_poisson_smooth_2d(jl, 0.8, tile_rows=16, interpret=True)
    assert rel(cuda_stencil.poisson2d_plain("apply", tp, tl.coeffs), app(jp)) <= RTOL
    assert rel(cuda_stencil.poisson2d_plain("residual", tp, tl.coeffs, tb),
               res(jp, jb)) <= RTOL
    assert rel(cuda_stencil.poisson2d_plain("smooth", tp, tl.coeffs, tb, w, 0.8),
               smo(jp, jb, jl.inv_diag)) <= RTOL
    # and the level apply of each package's multigrid
    assert rel(tmg.apply_op(tp), jmg.apply_op(jp)) <= RTOL


@pytest.mark.parametrize("periodic", [False, True])
def test_momentum2d_plain_matches_pallas(periodic):
    jns = j_tgv(N=16, nsteps=1, t_final=0.1, periodic=periodic)
    tns = t_tgv(N=16, nsteps=1, t_final=0.1, periodic=periodic, device="cpu",
                dtype=F64)
    jo, to = jns.impl.ops, tns.impl.ops
    rng = np.random.default_rng(0)
    m = to.mesh
    U0 = tuple(rng.standard_normal(m.face_shape(d)) for d in range(2))
    v0f = tuple(tuple(rng.standard_normal(m.face_shape(d)) for _ in range(2))
                for d in range(2))
    u, v = (rng.standard_normal(m.cell_shape) for _ in range(2))
    jW = jo.build_momentum_coeffs_stacked(
        tuple(map(jnp.asarray, U0)),
        tuple(tuple(map(jnp.asarray, r)) for r in v0f))
    tW = to.build_momentum_coeffs_stacked(
        tuple(map(torch.tensor, U0)),
        tuple(tuple(map(torch.tensor, r)) for r in v0f))
    kernel = build_momentum_apply_2d(16, 16, periodic, periodic, jnp.float64,
                                     interpret=True, tile_rows=8)
    want = kernel(jW, jnp.asarray(u), jnp.asarray(v))
    got = cuda_stencil.momentum2d_plain(tW, torch.tensor(u), torch.tensor(v),
                                        (periodic, periodic))
    for c in range(2):
        assert rel(got[c], want[c]) <= RTOL


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    _, tmg = mg_pair(False)
    lvl = tmg.levels[0]
    p = torch.randn(lvl.mesh.cell_shape, dtype=F64)
    W = torch.randn((26, *lvl.mesh.cell_shape), dtype=F64)
    before = [k.launches for k in cuda_stencil.KERNELS]
    out = cuda_stencil.poisson2d("apply", p, lvl.coeffs)
    assert torch.equal(out, cuda_stencil.poisson2d_plain("apply", p, lvl.coeffs))
    ou, ov = cuda_stencil.momentum2d(W, p, p, (False, False))
    pu, pv = cuda_stencil.momentum2d_plain(W, p, p, (False, False))
    assert torch.equal(ou, pu) and torch.equal(ov, pv)
    assert [k.launches for k in cuda_stencil.KERNELS] == before


def test_wrappers_refuse_bad_arguments():
    _, tmg = mg_pair(False)
    c = tmg.levels[0].coeffs
    N0, N1 = tmg.levels[0].mesh.cell_shape
    p = torch.zeros((N0, N1), dtype=F64)
    with pytest.raises(ValueError):  # wrong shape
        cuda_stencil.poisson2d("apply", torch.zeros((N0, N1 + 1), dtype=F64), c)
    with pytest.raises(TypeError):  # dtype differs from the coefficients'
        cuda_stencil.poisson2d("apply", p.float(), c)
    with pytest.raises(ValueError):  # not contiguous
        cuda_stencil.poisson2d("apply", torch.zeros((N1, N0), dtype=F64).t(), c)
    with pytest.raises(ValueError):  # residual needs b
        cuda_stencil.poisson2d("residual", p, c)
    with pytest.raises(ValueError):  # unknown mode
        cuda_stencil.poisson2d("jacobi", p, c, p)
    with pytest.raises(TypeError):  # integer fields
        cuda_stencil.momentum2d(torch.zeros((26, 4, 4), dtype=torch.int32),
                                torch.zeros((4, 4), dtype=torch.int32),
                                torch.zeros((4, 4), dtype=torch.int32), (0, 0))
    with pytest.raises(ValueError):  # wrong plane count
        cuda_stencil.momentum2d(torch.zeros((18, 4, 4)), torch.zeros((4, 4)),
                                torch.zeros((4, 4)), (0, 0))
    with pytest.raises(ValueError):  # u and v differ in shape
        cuda_stencil.momentum2d(torch.zeros((26, 4, 4)), torch.zeros((4, 4)),
                                torch.zeros((4, 5)), (0, 0))
    with pytest.raises(TypeError):  # W in another dtype
        cuda_stencil.momentum2d(torch.zeros((26, 4, 4), dtype=F64),
                                torch.zeros((4, 4)), torch.zeros((4, 4)), (0, 0))


def test_ns_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for machines without one")
    m = TMesh.create((8, 8))
    m.set_uniform_coordinates(0, 1, 0, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        NS(m, device="cuda", bcs=[t_wall()] * 4)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build stops with a clear error; it never falls
    back to anything."""
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present; the check is for machines without it")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_stencil, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_stencil.build_library()


def test_parallel_build_raises_the_failed_compile():
    """The per-source compiles all run to their end; a failure is raised
    with that command's output, never skipped."""
    ok = [sys.executable, "-c", "print('compiled')"]
    bad = [sys.executable, "-c", "import sys; sys.exit('boom')"]
    with pytest.raises(RuntimeError, match="boom"):
        cuda_stencil._run_nvcc([ok, bad, ok])
    cuda_stencil._run_nvcc([ok, ok])


def test_source_hash_tracks_sources():
    h = cuda_stencil.source_hash()
    assert h == cuda_stencil.source_hash() and len(h) == 16
    assert cuda_stencil.build_dir().name == "fluca_tpu_torch"
    for name in cuda_stencil.SOURCES + cuda_stencil.HEADERS:
        assert (cuda_stencil.CSRC_DIR / name).is_file()


# ----------------------------------------------------------------------
# the 2-D kernels' launch plans (csrc/poisson2d.cu, csrc/momentum2d.cu)
# ----------------------------------------------------------------------

# 4096^2 (the bench's SpMV); 256^2 and every level of its hierarchy (the
# cavity); 1024^2; 37x29 and 176x88 (the cylinder's grid); one row and one
# column; the local blocks of 32^2 and 4096^2 on (4, 2)
PLAN2D_SHAPES = [(4096, 4096), (256, 256), (128, 128), (64, 64), (32, 32), (1024, 1024),
                 (37, 29), (176, 88), (1, 1000), (1000, 1), (1, 1), (8, 16), (1024, 2048)]
PLAN2D = {"poisson2d": (cuda_stencil.poisson2d_launch_plan, 1, 512),
          "momentum2d": (cuda_stencil.momentum2d_launch_plan, 2, 256)}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, F64, torch.bfloat16])
@pytest.mark.parametrize("shape", PLAN2D_SHAPES)
@pytest.mark.parametrize("kernel", list(PLAN2D))
def test_2d_launch_plan_covers_every_cell_once(kernel, shape, dtype, aligned):
    """Every cell is computed by exactly one thread (the rows by one run,
    the columns by one lane of one warp, none past the row's end), within
    the card's grid, block and shared-memory limits; a lane holds at most
    16 bytes of cells, one unless the addresses are aligned, and a number
    of them that divides the row; the block stages the run's 4 axis-0
    values per row (Poisson)."""
    plan_of, reach, max_threads = PLAN2D[kernel]
    plan = plan_of(shape, dtype, aligned)
    rows, cols = march2d_cover(plan, shape, reach)
    assert np.array_equal(rows, np.ones(shape[0])) and np.array_equal(cols, np.ones(shape[1]))
    gx, gy = plan.grid
    assert gx < 2**31 and gy <= 65535 and 32 * plan.rows <= max_threads
    assert shape[1] % plan.vec == 0 and plan.vec * dtype.itemsize <= 16
    assert aligned or plan.vec == 1
    item = cuda_stencil.coef_dtype(dtype).itemsize
    assert plan.smem == (4 * item * plan.run if kernel == "poisson2d" else 0)
    assert list(plan.as_c()) == [gx, gy, plan.rows, plan.run, plan.vec, plan.smem]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PLAN2D_SHAPES)
@pytest.mark.parametrize("kernel", list(PLAN2D))
def test_2d_launch_plan_fills_the_card(kernel, shape, dtype):
    """A block per row (the momentum kernel; the Poisson kernel's coarse
    levels, where the shape has fewer rows and strips than twice its
    target) and so at least one block per SM of the H100's 132 where the
    shape has that many rows; up to 4 warps per
    block, fewer only where a row has fewer strips; the kernel's widest
    cells per lane (POISSON2D_VEC, MOMENTUM2D_VEC; half of them for the
    Poisson kernel's one-row runs) where the row allows them."""
    plan_of, reach, _ = PLAN2D[kernel]
    plan = plan_of(shape, dtype)
    strips = -(-shape[1] // cuda_stencil.march2d_columns(reach, plan.vec))
    gx, gy = plan.grid
    assert gx * gy >= min(132, shape[0])
    assert plan.rows == min(4, strips)
    if kernel == "momentum2d" or shape[0] * gx < 2 * cuda_stencil.POISSON2D_TARGET_BLOCKS:
        assert plan.run == 1
    wide = (cuda_stencil.POISSON2D_VEC if kernel == "poisson2d"
            else cuda_stencil.MOMENTUM2D_VEC)[dtype]
    if kernel == "poisson2d" and plan.run == 1:
        wide = max(1, wide // 2)  # one-row runs: half the cells per lane
    if shape[1] % wide == 0:
        assert plan.vec == wide


@pytest.mark.parametrize("shape", [(65535 * 64 + 1, 1),   # more runs than the grid's y extent
                                   (0, 4), (4, 0), (4,), (4, 4, 4)])
@pytest.mark.parametrize("kernel", list(PLAN2D))
def test_2d_launch_plan_refuses_what_cannot_fit(kernel, shape):
    with pytest.raises(ValueError):
        PLAN2D[kernel][0](shape, torch.float32)
