"""The port's FD tutorials (fluca_tpu_torch.tutorials.fd) against
fluca_tpu.tutorials.fd, case for case with tests/test_tutorials.py, on
the CPU: each in float64 at the reference test's size, its solution
within 1e-10 of fluca_tpu's (ex2-ex4: explicit SSP-RK3 runs of the same
arithmetic; ex1 solves a linear system by BiCGStab, whose solutions the
test holds to the solve's own bound, see there); each tutorial's own
physics checks run in both. Then each in float32 against the port's
float64 run within 1e-5 of its norm (the smoke's bound on the card), and
the command line."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.ops import fd as jfd
from fluca_tpu.tutorials import fd as jtut
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.ops import fd as tfd
from fluca_tpu_torch.tutorials import fd as ttut

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-10
CPU64 = dict(device="cpu", dtype=torch.float64)


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


def ex1_system(F, Mesh, arr, N=64, u_vel=1.0, gamma=0.05):
    """ex1's operator as a dense matrix and its right-hand side, built
    with a package's FD layer as the tutorial builds them."""
    m = Mesh.create((N,))
    m.set_uniform_coordinates(0.0, 1.0)
    bcs = [F.FDBC(F.FDBCType.DIRICHLET, 0.0), F.FDBC(F.FDBCType.DIRICHLET, 1.0)]
    conv = F.fd_scale(F.derivative(m, 0, 1, 2, bcs=bcs), u_vel)
    diff = F.fd_scale(F.derivative(m, 0, 2, 2, bcs=bcs), gamma)
    zero = arr(np.zeros(N))
    rhs = np.asarray(-(conv.apply(zero) - diff.apply(zero)))
    return conv.to_dense() - diff.to_dense(), rhs


def test_ex1_steady_convection_diffusion():
    """ex1 solves a linear system with BiCGStab to rtol 1e-10. The two
    packages build the same system to the bit; their solves, in 66
    iterations each, sum in another order and stop at residuals 4e-9 and
    5e-8 of the same tolerance, so their solutions part by ~2e-8, not
    1e-10. Each is held to the solve's own guarantee instead: within
    cond(A) * 1e-10 (7e-8) of the exact solution of the system."""
    want, exact = jtut.ex1_steady_convection_diffusion()
    got, texact = ttut.ex1_steady_convection_diffusion(**CPU64)
    np.testing.assert_array_equal(texact, exact)
    A, b = ex1_system(tfd, TMesh, torch.from_numpy)
    jA, jb = ex1_system(jfd, JMesh, jnp.asarray)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(b, jb)
    x = np.linalg.solve(A, b)
    bound = np.linalg.cond(A) * 1e-10
    assert rel(want, x) <= bound and rel(got, x) <= bound
    assert np.linalg.norm(A @ got - b) <= 1e-10 * np.linalg.norm(b)


@pytest.mark.parametrize("limiter", ["vanleer", "superbee", "minmod", "mc", "koren",
                                     "upwind"])
def test_ex2_tvd_limiters(limiter):
    want = jtut.ex2_unsteady_convection_tvd(limiter=limiter)
    got = ttut.ex2_unsteady_convection_tvd(limiter=limiter, **CPU64)
    assert rel(got, want) <= RTOL


def test_ex3_convection_diffusion_2d():
    want = jtut.ex3_convection_diffusion_2d()
    got = ttut.ex3_convection_diffusion_2d(**CPU64)
    assert got.shape == (32, 32) and rel(got, want) <= RTOL


def test_ex4_viscous_burgers():
    want = jtut.ex4_viscous_burgers()
    got = ttut.ex4_viscous_burgers(**CPU64)
    assert rel(got, want) <= RTOL


@pytest.mark.parametrize("name", list(ttut.TUTORIALS))
def test_float32_within_1e5_of_float64(name):
    """The tutorial in float32, its physics checks at float32's
    tolerance, within 1e-5 of the float64 run's norm."""
    fn = ttut.TUTORIALS[name]
    f64 = fn(**CPU64)
    f32 = fn(device="cpu", dtype=torch.float32)
    assert rel(f32, f64) <= ttut.F32_TOL


def test_self_check_fails_loudly():
    """A check that does not hold raises, whatever the interpreter's -O."""
    with pytest.raises(AssertionError, match="ex1"):
        ttut.ex1_steady_convection_diffusion(N=8, gamma=1e-4, **CPU64)


def test_command_line(capsys):
    assert ttut.main(["--device", "cpu", "--dtype", "float64"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["tutorial"] for x in lines] == ["ex1", "ex2", "ex3", "ex4"]
    assert all(x["device"]["platform"] == "cpu" and x["norm"] > 0 for x in lines)
