"""The port's TVD face interpolation and limiters
(fluca_tpu_torch.ops.tvd, .limiters) against fluca_tpu's in float64 on
the CPU, case for case with tests/test_tvd.py: every limiter of the
registry on a seeded r-grid, TVDOp.apply on each test's fields (both
velocity signs) and the boundary faces of every BC type, and
reference_stencil at every face; then the tests' own checks on the port.

Limiters: the same elementwise formulas, equal to the bit. apply and
reference_stencil: the same arithmetic on the same inputs, within 1e-12
of the reference's norm (the face gradient's bands are summed in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.ops.fd import FDBC as JBC
from fluca_tpu.ops.fd import FDBCType as JType
from fluca_tpu.ops.limiters import limiter_registry as jlim
from fluca_tpu.ops.tvd import TVDOp as JTVD
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.ops.fd import FDBC as TBC
from fluca_tpu_torch.ops.fd import FDBCType as TType
from fluca_tpu_torch.ops.limiters import limiter_registry as tlim
from fluca_tpu_torch.ops.tvd import TVDOp as TTVD

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-12
LIMITERS = jlim.names()
BCS = {"periodic": None, "none": "none", "dirichlet": "dirichlet", "neumann": "neumann"}


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-300)


def pair(N=16, periodic=True, limiter="vanleer", bc=None, values=(0.5, -1.5), shape=None,
         direction=0):
    """The same TVDOp in both packages: 1-D on [0, 1] (or ``shape`` on the
    unit square), periodic or with ``bc`` ("none", "dirichlet",
    "neumann") at both ends."""
    ops = []
    for Mesh, BC, Type, TVD in ((JMesh, JBC, JType, JTVD), (TMesh, TBC, TType, TTVD)):
        if shape is None:
            m = Mesh.create((N,), (periodic,))
            m.set_uniform_coordinates(0.0, 1.0)
        else:
            m = Mesh.create(shape, (periodic,) * len(shape))
            m.set_uniform_coordinates(*[0, 1] * len(shape))
        bcs = None if bc is None else [BC(Type(bc), v) for v in values] * m.dim
        ops.append(TVD(m, direction, limiter=limiter, bcs=bcs))
    return ops


def both(jop, top, x, vel):
    want = np.asarray(jop.apply(jnp.asarray(x), jnp.asarray(vel)))
    got = top.apply(torch.from_numpy(x), torch.from_numpy(vel))
    return got.numpy(), want


@pytest.mark.parametrize("name", LIMITERS)
def test_limiter_matches_reference(name):
    """test_tvd.py's limiter values: each limiter of the registry equal to
    fluca_tpu's on a seeded r-grid (negative, zero, around 1, large)."""
    rng = np.random.default_rng(0)
    r = np.concatenate([rng.uniform(-5, 5, 500), rng.standard_normal(100) * 1e3,
                        [0.0, 1.0, -1.0 + 1e-9, 2.0, 0.5, 1e30, -1e30]])
    want = np.asarray(jlim.get(name)(jnp.asarray(r)))
    got = tlim.get(name)(torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, want)
    # psi(1) = 1 for all but upwind (second-order consistency)
    one = float(tlim.get(name)(torch.tensor(1.0, dtype=torch.float64)))
    assert one == (0.0 if name == "upwind" else pytest.approx(1.0, abs=1e-12))


def test_limiter_registry_matches_reference():
    assert tlim.names() == jlim.names() and len(LIMITERS) == 11
    get = tlim.get
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    assert float(get("superbee")(t(0.5))) == 1.0
    assert float(get("minmod")(t(2.0))) == 1.0
    assert float(get("sou")(t(2.0))) == 2.0
    assert float(get("quick")(t(2.0))) == 1.25
    for name in ("superbee", "minmod", "mc", "vanleer", "vanalbada", "koren",
                 "barthjesperson", "venkatakrishnan"):
        assert abs(float(get(name)(t(-1.0)))) < 1e-12


def test_upwind_limiter_pure_upwind():
    jop, top = pair(limiter="upwind")
    phi = np.random.default_rng(0).standard_normal(16)
    for sgn, want_np in ((1.0, np.roll(phi, 1)), (-1.0, phi)):
        got, want = both(jop, top, phi, np.full(16, sgn))
        assert rel(got, want) <= RTOL
        np.testing.assert_allclose(got, want_np)


@pytest.mark.parametrize("limiter", ["superbee", "minmod", "mc", "vanleer", "koren"])
def test_tvd_boundedness(limiter):
    """test_tvd.py's step + spike on 32 cells, both velocity signs: equal
    to fluca_tpu's, and within the neighbouring cells' bounds."""
    jop, top = pair(32, limiter=limiter)
    x = jop.mesh.centers(0)
    phi = np.where(x < 0.5, 1.0, 0.0)
    phi[10] = 2.0
    for sgn in (1.0, -1.0):
        got, want = both(jop, top, phi, np.full(32, sgn))
        assert rel(got, want) <= RTOL
        lo = np.minimum(phi, np.roll(phi, 1))
        hi = np.maximum(phi, np.roll(phi, 1))
        assert np.all(got >= lo - 1e-12) and np.all(got <= hi + 1e-12)


def test_tvd_smooth_second_order():
    errs_tvd, errs_up = [], []
    for N in (32, 64):
        for limiter, errs in (("vanleer", errs_tvd), ("upwind", errs_up)):
            jop, top = pair(N, limiter=limiter)
            x, f = jop.mesh.centers(0), jop.mesh.face_coords(0)
            got, want = both(jop, top, np.sin(2 * np.pi * x) + 2.0, np.ones(N))
            assert rel(got, want) <= RTOL
            errs.append(np.max(np.abs(got - (np.sin(2 * np.pi * f) + 2.0))))
    assert errs_tvd[1] < errs_up[1] / 3
    assert errs_tvd[0] / errs_tvd[1] > 2.5


@pytest.mark.parametrize("bc", ["dirichlet", "neumann", "none"])
@pytest.mark.parametrize("limiter", ["minmod", "vanleer"])
def test_tvd_boundary_faces(bc, limiter):
    """The boundary faces of every BC type (test_tvd.py's Dirichlet case
    among them: the faces take 5 and 7), at inflow and outflow."""
    values = (5.0, 7.0) if bc == "dirichlet" else (0.5, -1.5)
    jop, top = pair(16, periodic=False, limiter=limiter, bc=bc, values=values)
    phi = np.linspace(5, 7, 16) + 0.1 * np.random.default_rng(2).standard_normal(16)
    for sgn in (1.0, -1.0):
        got, want = both(jop, top, phi, np.full(17, sgn))
        assert rel(got, want) <= RTOL
        if bc == "dirichlet":
            np.testing.assert_allclose(got[[0, -1]], [5.0, 7.0])


@pytest.mark.parametrize("direction", [0, 1])
def test_tvd_2d_direction(direction):
    jop, top = pair(limiter="vanleer", shape=(8, 16), direction=direction)
    rng = np.random.default_rng(1)
    phi = rng.standard_normal((8, 16))
    vel = np.sign(rng.standard_normal((8, 16)))
    got, want = both(jop, top, phi, vel)
    assert got.shape == (8, 16) and np.all(np.isfinite(got))
    assert rel(got, want) <= RTOL
    # the deferred correction from another field than the linear part
    phi2 = rng.standard_normal((8, 16))
    want = np.asarray(jop.apply(jnp.asarray(phi), jnp.asarray(vel), jnp.asarray(phi2)))
    got = top.apply(torch.from_numpy(phi), torch.from_numpy(vel), torch.from_numpy(phi2))
    assert rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("limiter", ["vanleer", "superbee"])
def test_reference_stencil_matches_reference(bc, limiter):
    """reference_stencil (the reference's printed decomposition, its
    outflow-face quirk included) at every face for both velocity signs:
    the same entries, weights within 1e-12."""
    periodic = bc == "periodic"
    jop, top = pair(12, periodic=periodic, limiter=limiter, bc=BCS[bc])
    rng = np.random.default_rng(4)
    phi = rng.standard_normal(12)
    nf = 12 if periodic else 13
    for sgn in (1.0, -1.0):
        vel = np.full(nf, sgn)
        for i in range(nf):
            want = jop.reference_stencil(i, vel, phi)
            got = top.reference_stencil(i, torch.from_numpy(vel), torch.from_numpy(phi))
            assert [(k, c) for k, c, _ in got] == [(k, c) for k, c, _ in want], i
            for (_, _, g), (_, _, w) in zip(got, want):
                assert abs(g - w) <= RTOL * max(abs(w), 1.0), i
