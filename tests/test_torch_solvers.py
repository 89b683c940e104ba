"""fluca_tpu_torch Krylov solvers and multigrid against fluca_tpu on the
same operators in float64: the pressure Poisson operator with its
V-cycle preconditioner and nullspace projection (CG), and the momentum
block A of a cavity step (BiCGStab, GCR, FGMRES).

Tolerance: ||x_port - x_ref|| <= 1e-10 * ||x_ref||. The operators agree
to ~1e-15 (tests/test_torch_operators.py); the solvers run the same
iteration, so the iterates differ only by roundoff carried through a
few dozen iterations. A different iteration (a missed projection, a
wrong Givens rotation) shows at 1e-4 or more."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JCond
from fluca_tpu.ns.bc import zero_velocity_bc as j_wall
from fluca_tpu.solvers import krylov as JK
from fluca_tpu.solvers.mg import PoissonMG as JMG
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.models.cavity import setup_cavity_2d as t_cavity
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TCond
from fluca_tpu_torch.ns.bc import zero_velocity_bc as t_wall
from fluca_tpu_torch.solvers import krylov as TK
from fluca_tpu_torch.solvers.mg import PoissonMG as TMG

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-10
F64 = torch.float64


def rel(got, want):
    g = np.concatenate([x.numpy().ravel() for x in TK.tree_leaves(got)])
    w = np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(want)])
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def cavities(N):
    jns = j_cavity(N=N, Re=100.0, dt=0.05)
    tns = t_cavity(N=N, Re=100.0, dt=0.05, device="cpu", dtype=F64)
    return jns.impl, tns.impl


@pytest.fixture(scope="module")
def poisson():
    """(JAX impl, port impl, rhs) for the Schur solve at 64^2 (two MG
    levels)."""
    ji, ti = cavities(64)
    rng = np.random.default_rng(5)
    r = rng.standard_normal((64, 64))
    return ji, ti, r


def projector(impl, xp):
    vol = impl.mg.levels[0].vol

    def proj(p):
        return p - xp.sum(vol * p) / xp.sum(vol)

    return proj


@pytest.mark.parametrize("fixed", [False, True])
def test_cg_mg_matches(poisson, fixed):
    ji, ti, r = poisson
    jb = ji.mg.scale_rhs(jnp.asarray(r))
    tb = ti.mg.scale_rhs(torch.tensor(r))
    jproj, tproj = projector(ji, jnp), projector(ti, torch)
    if fixed:
        want = JK.cg_fixed(ji.mg.apply_op, jb, 7, M=ji.mg.precondition,
                           project=jproj)
        got = TK.cg(ti.mg.apply_op, tb, maxiter=7, M=ti.mg.precondition,
                    project=tproj)
    else:
        want = JK.cg(ji.mg.apply_op, jb, rtol=1e-8, maxiter=50,
                     M=ji.mg.precondition, project=jproj)
        got = TK.cg(ti.mg.apply_op, tb, rtol=1e-8, maxiter=50,
                    M=ti.mg.precondition, project=tproj)
        assert got.iters == int(want.iters) and bool(got.converged)
    assert rel(got.x, want.x) <= RTOL
    assert abs(float(got.rnorm) - float(want.rnorm)) <= 1e-8 * float(want.rnorm)


@pytest.fixture(scope="module")
def momentum():
    """The momentum block A of a 24^2 cavity with a random advecting
    field, Jacobi preconditioner, and a random rhs, in both packages."""
    ji, ti = cavities(24)
    jo, to = ji.ops, ti.ops
    rng = np.random.default_rng(9)
    m = to.mesh
    U0 = tuple(0.5 * rng.standard_normal(m.face_shape(d)) for d in range(2))
    v0f = tuple(tuple(0.5 * rng.standard_normal(m.face_shape(d)) for _ in range(2))
                for d in range(2))
    b = tuple(rng.standard_normal(m.cell_shape) for _ in range(2))
    jU, jv0f = tuple(map(jnp.asarray, U0)), tuple(tuple(map(jnp.asarray, r)) for r in v0f)
    tU, tv0f = tuple(map(torch.tensor, U0)), tuple(tuple(map(torch.tensor, r)) for r in v0f)
    W = to.build_momentum_coeffs_stacked(tU, tv0f)
    jinv = tuple(1.0 / d for d in jo.diag_A(jU, jv0f))
    tinv = tuple(1.0 / d for d in to.diag_A(tU, tv0f))
    jA = lambda v: jo.apply_A(v, jU, jv0f)  # noqa: E731
    tA = lambda v: to.apply_A_coeffs(v, W)  # noqa: E731
    jM = lambda r: tuple(i * x for i, x in zip(jinv, r))  # noqa: E731
    tM = lambda r: tuple(i * x for i, x in zip(tinv, r))  # noqa: E731
    return (jA, jM, tuple(map(jnp.asarray, b))), (tA, tM, tuple(map(torch.tensor, b)))


@pytest.mark.parametrize("fixed", [False, True])
def test_bicgstab_matches(momentum, fixed):
    (jA, jM, jb), (tA, tM, tb) = momentum
    if fixed:
        want = JK.bicgstab_fixed(jA, jb, 6, M=jM)
        got = TK.bicgstab(tA, tb, maxiter=6, M=tM)
    else:
        want = JK.bicgstab(jA, jb, rtol=1e-9, maxiter=60, M=jM)
        got = TK.bicgstab(tA, tb, rtol=1e-9, maxiter=60, M=tM)
        assert got.iters == int(want.iters) and bool(got.converged)
    assert rel(got.x, want.x) <= RTOL


def test_gcr_matches(momentum):
    (jA, jM, jb), (tA, tM, tb) = momentum
    want = JK.gcr(jA, jb, maxiter=5, M=jM)
    got = TK.gcr(tA, tb, maxiter=5, M=tM)
    assert got.iters == 5 and rel(got.x, want.x) <= RTOL
    assert abs(float(got.rnorm) - float(want.rnorm)) <= 1e-9 * float(want.rnorm)


@pytest.mark.parametrize("restart", [4, 30])
def test_fgmres_matches(momentum, restart):
    (jA, jM, jb), (tA, tM, tb) = momentum
    want = JK.fgmres(jA, jb, rtol=1e-9, restart=restart, maxiter=80, M=jM)
    got = TK.fgmres(tA, tb, rtol=1e-9, restart=restart, maxiter=80, M=tM)
    assert got.iters == int(want.iters)
    assert bool(got.converged) and bool(want.converged)
    assert rel(got.x, want.x) <= RTOL
    assert abs(float(got.rnorm) - float(want.rnorm)) <= 1e-6 * float(want.rnorm)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("periodic", [False, True])
def test_mg_precondition_matches(periodic, smoother):
    N = (128, 64)  # three levels: 128x64, 64x32, 32x16 (coarse pinv)
    f = [np.linspace(0.0, 1.0, n + 1) ** 1.2 for n in N]
    jm, tm = JMesh.create(N, (periodic,) * 2), TMesh.create(N, (periodic,) * 2)
    jm.set_coordinates(*f)
    tm.set_coordinates(*f)
    jb = JCond(JBC.PERIODIC) if periodic else j_wall()
    tb = TCond(TBC.PERIODIC) if periodic else t_wall()
    jmg = JMG(jm, [jb] * 4, scale=0.02, dtype=jnp.float64, smoother=smoother)
    tmg = TMG(tm, [tb] * 4, scale=0.02, dtype=F64, device="cpu", smoother=smoother)
    assert [lv.mesh.N for lv in tmg.levels] == [lv.mesh.N for lv in jmg.levels]
    assert len(tmg.levels) == 3
    if smoother == "chebyshev":
        for jl, tl in zip(jmg.levels, tmg.levels):
            assert abs(tl.cheb_lmax - jl.cheb_lmax) <= 1e-10 * jl.cheb_lmax
    r = np.random.default_rng(11).standard_normal(N)
    got = tmg.precondition(torch.tensor(r))
    want = jmg.precondition(jnp.asarray(r))
    assert rel(got, want) <= RTOL
