"""The port's immersed boundary method (fluca_tpu_torch.ibm) against
fluca_tpu.ibm in float64 on the CPU: the delta kernels, the marker sets,
interpolation and spreading, and the direct forcing; and the port's own
adjointness, force conservation and spread determinism.

Tolerances, as ||port - ref|| / ||ref||:
- the delta kernels, 1e-15: the same expression in the same order;
- marker positions and weights, 1e-14: the same numpy host arithmetic;
- interpolation and spreading, 1e-13: the same windows and weights; the
  port sums a window in another order than XLA's reduction, and spreads
  through a sorted segmented sum where XLA scatters in marker order, so
  they agree to a few roundings per cell, not bit for bit;
- the direct forcing, 1e-12: four sweeps of interpolation and spreading
  compound those roundings.
A wrong tap, weight, wrap or scale gives O(1e-2) or more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.ibm import delta as j_delta
from fluca_tpu.ibm.forcing import DirectForcingIBM as JForcing
from fluca_tpu.ibm.markers import MarkerSet as JMarkerSet
from fluca_tpu.ibm.markers import circle_markers as j_circle
from fluca_tpu.ibm.markers import sphere_markers as j_sphere
from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu_torch.ibm import delta as t_delta
from fluca_tpu_torch.ibm.forcing import DirectForcingIBM as TForcing
from fluca_tpu_torch.ibm.markers import MarkerSet as TMarkerSet
from fluca_tpu_torch.ibm.markers import circle_markers as t_circle
from fluca_tpu_torch.ibm.markers import sphere_markers as t_sphere
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

F64 = torch.float64


def rel(got, ref) -> float:
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def meshes(N, periodic=None, lo=0.0, hi=1.0):
    dim = len(N)
    out = []
    for M in (JMesh, TMesh):
        m = M.create(N, periodic)
        m.set_uniform_coordinates(*([lo, hi] * dim))
        out.append(m)
    return out


def marker_pair(dim, retract=0.0, periodic=None, center=None, radius=0.2):
    """(fluca_tpu markers, port markers) on a unit box of 32^2 or 16^3."""
    jm, tm = meshes((32, 32) if dim == 2 else (16, 16, 16), periodic)
    center = center or (0.5,) * dim
    jf, tf = (j_circle, t_circle) if dim == 2 else (j_sphere, t_sphere)
    return (jf(jm, center, radius, dtype=jnp.float64, retract=retract),
            tf(tm, center, radius, dtype=F64, retract=retract, device="cpu"))


@pytest.mark.parametrize("name", ["roma3", "peskin4"])
def test_torch_delta_kernels(name):
    r = np.concatenate([np.linspace(-2.5, 2.5, 2001),
                        [-2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0]])
    ref = np.asarray(j_delta.KERNELS[name][0](jnp.asarray(r)))
    got = t_delta.KERNELS[name][0](torch.tensor(r, dtype=F64))
    assert rel(got, ref) <= 1e-15
    assert t_delta.KERNELS[name][1] == j_delta.KERNELS[name][1]
    # the port's own moment conditions: partition of unity, first moment
    for shift in (0.0, 0.2, 0.49, 0.77):
        rr = torch.arange(-4, 5, dtype=F64) - shift
        phi = t_delta.KERNELS[name][0](rr)
        assert abs(float(phi.sum()) - 1.0) <= 1e-12
        assert abs(float((rr * phi).sum())) <= 1e-12


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("retract", [0.0, 0.5])
def test_torch_marker_geometry(dim, retract):
    jm, tm = marker_pair(dim, retract)
    assert rel(tm.X, jm.X) <= 1e-14
    assert rel(tm.ds, jm.ds) <= 1e-14
    assert tm.X.dtype == F64 and tm.X.device.type == "cpu"
    np.testing.assert_array_equal(tm.h, jm.h)
    np.testing.assert_array_equal(tm.x0, jm.x0)
    np.testing.assert_array_equal(tm.offsets, jm.offsets)
    with pytest.raises(ValueError, match="retract"):
        (t_circle if dim == 2 else t_sphere)(tm.mesh, (0.5,) * dim, 0.2, retract=20.0,
                                             device="cpu")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("periodic", [False, True])
def test_torch_windows_like_reference(dim, periodic):
    """Indices exactly, weights to rounding, with the window wrapped on a
    periodic axis or clamped on a wall, for a body that crosses the box's
    edge."""
    jm, tm = marker_pair(dim, periodic=(periodic,) * dim, center=(0.02,) * dim,
                         radius=0.1)
    jidx, jw = jm._windows(jm.X)
    tidx, tw = tm._windows(tm.X)
    assert tidx.dtype == torch.int64
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert rel(tw, jw) <= 1e-15


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("periodic", [False, True])
def test_torch_interpolate_spread(dim, periodic):
    jm, tm = marker_pair(dim, periodic=(periodic,) * dim, center=(0.1,) * dim, radius=0.15)
    rng = np.random.default_rng(dim)
    u = rng.standard_normal(tm.mesh.cell_shape)
    F = rng.standard_normal(tm.X.shape[0])
    assert rel(tm.interpolate(torch.tensor(u)), jm.interpolate(jnp.asarray(u))) <= 1e-13
    assert rel(tm.spread(torch.tensor(F)), jm.spread(jnp.asarray(F))) <= 1e-13
    # explicit (moved) positions take the same path as the markers' own
    X2 = np.asarray(jm.X) + 0.013
    assert rel(tm.interpolate(torch.tensor(u), X=torch.tensor(X2)),
               jm.interpolate(jnp.asarray(u), X=jnp.asarray(X2))) <= 1e-13
    assert rel(tm.spread(torch.tensor(F), X=torch.tensor(X2)),
               jm.spread(jnp.asarray(F), X=jnp.asarray(X2))) <= 1e-13


@pytest.mark.parametrize("dim", [2, 3])
def test_torch_spread_adjoint_and_conservative(dim):
    """<E u, F ds> == <u, S F> vol, and the spread force integrates to
    sum(F ds), as tests/test_ibm.py holds fluca_tpu."""
    _, mk = marker_pair(dim, radius=0.22)
    rng = np.random.default_rng(7)
    u = torch.tensor(rng.standard_normal(mk.mesh.cell_shape))
    F = torch.tensor(rng.standard_normal(mk.X.shape[0]))
    vol = float(np.prod(mk.h))
    lhs = float(torch.sum(mk.interpolate(u) * F * mk.ds))
    rhs = float(torch.sum(u * mk.spread(F))) * vol
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
    ones = torch.ones(mk.X.shape[0], dtype=F64)
    np.testing.assert_allclose(float(mk.spread(ones).sum()) * vol, float(mk.ds.sum()),
                               rtol=1e-10)
    # linear fields interpolate exactly
    xs = torch.meshgrid(*(torch.tensor(mk.mesh.centers(d)) for d in range(dim)),
                        indexing="ij")
    lin = sum((2.0 - 3.0 * d) * x for d, x in enumerate(xs)) + 1.0
    exact = sum((2.0 - 3.0 * d) * mk.X[:, d] for d in range(dim)) + 1.0
    assert float((mk.interpolate(lin) - exact).abs().max()) <= 1e-10


def test_torch_spread_fixed_order_and_cached():
    """The spread is one sum per touched cell in marker order: equal, at
    max abs 0, to a plain loop adding the (marker, tap) contributions in
    that order; the stationary body's windows are computed once."""
    _, mk = marker_pair(2, radius=0.2)
    rng = np.random.default_rng(3)
    F = torch.tensor(rng.standard_normal(mk.X.shape[0]))
    got = mk.spread(F)
    plan = mk.plan()
    assert mk.plan() is plan and mk.plan(mk.X) is not plan
    vals = ((mk.ds / float(np.prod(mk.h))) * F)[:, None] * plan.weights
    lin, vals = plan.lin.reshape(-1).tolist(), vals.reshape(-1).tolist()
    cells = {}
    for c, x in zip(lin, vals):
        cells.setdefault(c, []).append(x)
    ref = torch.zeros(mk.mesh.cell_shape, dtype=F64).reshape(-1)
    for c, xs in cells.items():
        ref[c] = torch.tensor(xs, dtype=F64).sum()
    assert torch.equal(got.reshape(-1), ref)
    assert torch.equal(mk.spread(F), got)


def test_torch_markers_need_uniform_spacing():
    m = TMesh.create((8, 8))
    m.set_coordinates(np.linspace(0, 1, 9) ** 2, np.linspace(0, 1, 9))
    with pytest.raises(ValueError, match="uniform"):
        TMarkerSet(m, torch.zeros((4, 2), dtype=F64), torch.ones(4, dtype=F64))


def seeded_state(mesh, rng):
    dim = mesh.dim
    return {
        "v": tuple(rng.standard_normal(mesh.cell_shape) for _ in range(dim)),
        "U": tuple(rng.standard_normal(mesh.face_shape(d)) for d in range(dim)),
    }


@pytest.mark.parametrize("dim", [2, 3])
def test_torch_direct_forcing(dim):
    jm, tm = marker_pair(dim, radius=0.2)
    rng = np.random.default_rng(11 + dim)
    st = seeded_state(tm.mesh, rng)
    jst = {k: tuple(jnp.asarray(a) for a in v) for k, v in st.items()}
    tst = {k: tuple(torch.tensor(a) for a in v) for k, v in st.items()}
    jf, tf = JForcing(jm, 5e-3), TForcing(tm, 5e-3)
    for a, b in zip(tf.body_force(tst, 0.0), jf.body_force(jst, 0.0)):
        assert rel(a, b) <= 1e-12
    assert rel(tf.hydrodynamic_force(tst, 0.0, 1.0),
               jf.hydrodynamic_force(jst, 0.0, 1.0)) <= 1e-12
    # a moving body
    def jvel(t, X):
        return jnp.stack([0.3 + 0.0 * X[:, 0]] + [0.1 * X[:, 0]] * (dim - 1), axis=1)

    def tvel(t, X):
        return torch.stack([0.3 + 0.0 * X[:, 0]] + [0.1 * X[:, 0]] * (dim - 1), dim=1)

    jf, tf = JForcing(jm, 5e-3, body_velocity=jvel, n_iter=2), TForcing(
        tm, 5e-3, body_velocity=tvel, n_iter=2)
    assert rel(tf.marker_forces(tst, 0.0), jf.marker_forces(jst, 0.0)) <= 1e-12
