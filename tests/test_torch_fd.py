"""The port's FD operator algebra (fluca_tpu_torch.ops.fd) against
fluca_tpu.ops.fd in float64 on the CPU, case for case with
tests/test_fd.py: every operator those tests build is built in both
packages from the same grid and held as

- its assembled matrix (to_dense): equal within 1e-12 of its norm;
- its apply, constant included, on a field from seeded numpy: within
  1e-12 of the reference's norm;
- its rows: the marker-level rows (row_entries) of a derivative-built
  or composed operator, else the plain rows (row) with their constants,
  at every output point, equal within 1e-12 of the largest weight.

The bands are built on the host in float64 by the same code in both, so
the matrices agree to the last bit but for XLA's and torch's summation
order in the composed constants; the bound leaves room for that only. A
wrong fold, offset or weight shows at 1e-3 or more. Then the
tests' own analytic checks on the port, the Laplace solve of test_fd.py
in both, and an operator carried from fluca_tpu to the port
(stencil_op_from_numpy)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluca_tpu.ops.fd as jfd
import fluca_tpu.ops.tvd as jtvd
import fluca_tpu_torch.ops.fd as tfd
import fluca_tpu_torch.ops.tvd as ttvd
from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.solvers.krylov import bicgstab as jbicgstab
from fluca_tpu.utils.options import Options as JOptions
from fluca_tpu_torch.interop import stencil_op_from_numpy
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.solvers.krylov import bicgstab as tbicgstab
from fluca_tpu_torch.utils.options import Options as TOptions

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-12
F64 = torch.float64
J = SimpleNamespace(fd=jfd, tvd=jtvd, Mesh=JMesh, Options=JOptions, field=jnp.asarray,
                    host=np.asarray)
T = SimpleNamespace(fd=tfd, tvd=ttvd, Mesh=TMesh, Options=TOptions, field=torch.from_numpy,
                    host=lambda t: t.numpy())


def mesh1d(P, N=8, periodic=False, lo=0.0, hi=1.0):
    m = P.Mesh.create((N,), (periodic,))
    m.set_uniform_coordinates(lo, hi)
    return m


def mesh2d(P, shape=(8, 8), hi=(1, 1)):
    m = P.Mesh.create(shape)
    m.set_uniform_coordinates(0, hi[0], 0, hi[1])
    return m


def dirichlet(P, lo, hi):
    return [P.fd.FDBC(P.fd.FDBCType.DIRICHLET, lo), P.fd.FDBC(P.fd.FDBCType.DIRICHLET, hi)]


def none2(P):
    return [P.fd.FDBC(P.fd.FDBCType.NONE)] * 2


# every operator of tests/test_fd.py, by the test that builds it: a
# function of the package namespace returning the operator
def _laplace24(P):
    m = mesh2d(P, (24, 24))
    bcs = [P.fd.FDBC(P.fd.FDBCType.DIRICHLET, 0.0)] * 4
    return P.fd.fd_sum(P.fd.derivative(m, 0, 2, 2, bcs=bcs), P.fd.derivative(m, 1, 2, 2, bcs=bcs))


def _from_options(P):
    o = P.Options({"flucafd_type": "derivative", "flucafd_dir": "x",
                   "flucafd_deriv_order": "2", "flucafd_accu_order": "2",
                   "flucafd_left_bc_type": "dirichlet", "flucafd_left_bc_value": "1.0"})
    return P.fd.fd_from_options(mesh1d(P), o)


OPERATORS = {
    "first_derivative_central": lambda P: P.fd.derivative(mesh1d(P), 0, 1, 2),
    "second_derivative_central": lambda P: P.fd.derivative(mesh1d(P), 0, 2, 2),
    "derivative_none_bc_one_sided": lambda P: P.fd.derivative(mesh1d(P), 0, 1, 2),
    "derivative_dirichlet_bc": lambda P: P.fd.derivative(
        mesh1d(P), 0, 1, 2, bcs=dirichlet(P, 2.0, 2.0)),
    "derivative_neumann_bc": lambda P: P.fd.derivative(
        mesh1d(P), 0, 2, 1, bcs=[P.fd.FDBC(P.fd.FDBCType.NEUMANN, 3.0),
                                 P.fd.FDBC(P.fd.FDBCType.NEUMANN, 5.0)]),
    "derivative_periodic_wraps": lambda P: P.fd.derivative(mesh1d(P, periodic=True), 0, 1, 2),
    "derivative_cell_to_face": lambda P: P.fd.derivative(
        mesh1d(P), 0, 1, 1, in_stag=(False,), out_stag=(True,), bcs=none2(P)),
    "derivative_face_to_cell": lambda P: P.fd.derivative(
        mesh1d(P), 0, 1, 1, in_stag=(True,), out_stag=(False,), bcs=none2(P)),
    "sum_2d_laplacian": lambda P: P.fd.fd_sum(P.fd.derivative(mesh2d(P), 0, 2, 2),
                                              P.fd.derivative(mesh2d(P), 1, 2, 2)),
    "scale_constant": lambda P: P.fd.fd_scale(P.fd.derivative(mesh1d(P), 0, 1, 2), 2.0),
    "scale_field": lambda P: P.fd.fd_scale(P.fd.derivative(mesh1d(P), 0, 1, 2),
                                           mesh1d(P).centers(0)),
    "scaled_field_op_runtime": lambda P: P.fd.ScaledFieldOp(
        P.fd.derivative(mesh1d(P), 0, 1, 2)),
    "composition_dxx_equals_dx_of_dx": lambda P: P.fd.fd_compose(
        P.fd.derivative(mesh1d(P, 16), 0, 1, 1, in_stag=(True,), out_stag=(False,),
                        bcs=none2(P)),
        P.fd.derivative(mesh1d(P, 16), 0, 1, 1, in_stag=(False,), out_stag=(True,),
                        bcs=none2(P))),
    "composition_cross_derivative": lambda P: P.fd.fd_compose(
        P.fd.derivative(mesh2d(P), 0, 1, 2), P.fd.derivative(mesh2d(P), 1, 1, 2)),
    "composition_const_flows_through": lambda P: P.fd.fd_compose(
        P.fd.derivative(mesh1d(P), 0, 1, 2),
        P.fd.derivative(mesh1d(P), 0, 1, 2, bcs=dirichlet(P, 0.0, 1.0))),
    "laplace_solve_via_fd_operator": _laplace24,
    "apply_matches_dense": lambda P: P.fd.fd_sum(
        P.fd.derivative(mesh2d(P, (6, 5), (1, 2)), 0, 2, 2),
        P.fd.derivative(mesh2d(P, (6, 5), (1, 2)), 1, 2, 2)),
    "fd_from_options": _from_options,
    "fourth_order_accuracy": lambda P: P.fd.derivative(mesh1d(P, 32), 0, 1, 4),
    "derivative_3d": lambda P: P.fd.derivative(
        _mesh3d(P), 2, 1, 2),
    # beyond test_fd.py: a fold on a composite (a Dirichlet-folded second
    # derivative of derivative-built operands, its markers), a
    # non-uniform grid, and a fallback composition of a scaled operand
    "composition_dirichlet_folded": lambda P: P.fd.fd_compose(
        P.fd.derivative(mesh1d(P, 12), 0, 1, 2), P.fd.derivative(mesh1d(P, 12), 0, 1, 2),
        bcs=dirichlet(P, 1.0, -2.0)),
    "stretched_grid_neumann": lambda P: P.fd.derivative(
        _stretched(P), 0, 2, 2, bcs=[P.fd.FDBC(P.fd.FDBCType.NEUMANN, 0.5),
                                     P.fd.FDBC(P.fd.FDBCType.DIRICHLET, 2.0)]),
    "composition_of_scaled_fallback": lambda P: P.fd.fd_compose(
        P.fd.fd_scale(P.fd.derivative(mesh1d(P), 0, 1, 2), 3.0),
        P.fd.derivative(mesh1d(P), 0, 1, 2, bcs=dirichlet(P, 1.0, 0.5))),
}


def _mesh3d(P):
    m = P.Mesh.create((6, 6, 6))
    m.set_uniform_coordinates(0, 1, 0, 1, 0, 1)
    return m


def _stretched(P):
    m = P.Mesh.create((10,))
    m.set_coordinates(np.tanh(np.linspace(-1.5, 1.5, 11)))
    return m


def _stencil(op):
    return op.op if isinstance(op, (jfd.ScaledFieldOp, tfd.ScaledFieldOp)) else op


def build(case):
    return OPERATORS[case](J), OPERATORS[case](T)


def seeded_in(op, seed=0):
    op = _stencil(op)
    shape = jfd._loc_shape(op.mesh, op.in_stag)
    return np.random.default_rng(seed).standard_normal(shape)


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("case", list(OPERATORS))
def test_operator_to_dense_matches_reference(case):
    jop, top = (_stencil(o) for o in build(case))
    A, B = top.to_dense(), jop.to_dense()
    assert A.shape == B.shape and np.linalg.norm(B) > 0
    assert rel(A, B) <= RTOL
    assert np.linalg.norm(top.const - jop.const) <= RTOL * max(np.linalg.norm(jop.const), 1.0)
    assert (top.in_stag, top.out_stag) == (jop.in_stag, jop.out_stag)
    assert sorted(top.bands) == sorted(jop.bands)


@pytest.mark.parametrize("case", list(OPERATORS))
def test_operator_apply_matches_reference(case):
    jop, top = build(case)
    x = seeded_in(jop)
    if isinstance(jop, jfd.ScaledFieldOp):
        sop = _stencil(jop)
        f = np.random.default_rng(1).standard_normal(
            jfd._loc_shape(sop.mesh, sop.out_stag))
        jop.set_field(jnp.asarray(f))
        top.set_field(torch.from_numpy(f))
        want = np.asarray(jop(jnp.asarray(x)))
        got = top(torch.from_numpy(x)).numpy()
        assert rel(got, want) <= RTOL
        return
    for include_const in (True, False):
        want = np.asarray(jop.apply(jnp.asarray(x), include_const=include_const))
        got = top.apply(torch.from_numpy(x), include_const=include_const)
        assert got.dtype == F64 and tuple(got.shape) == want.shape
        assert rel(got.numpy(), want) <= RTOL


def _close_dict(a, b, scale):
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) <= RTOL * scale, k


@pytest.mark.parametrize("case", list(OPERATORS))
def test_operator_rows_match_reference(case):
    jop, top = (_stencil(o) for o in build(case))
    n_out = jfd._loc_shape(jop.mesh, jop.out_stag)
    scale = max(np.abs(w).max() for w in jop.bands.values())
    for idx in np.ndindex(*n_out):
        if jop.folded1d is not None:
            jpts, jmarks = jop.row_entries(idx)
            tpts, tmarks = top.row_entries(idx)
            _close_dict(tpts, jpts, scale)
            assert [(s, c) for s, c, _ in tmarks] == [(s, c) for s, c, _ in jmarks]
            for (_, _, tw), (_, _, jw) in zip(tmarks, jmarks):
                assert abs(tw - jw) <= RTOL * scale
        else:
            assert top.folded1d is None
        jrow, jconst = jop.row(idx)
        trow, tconst = top.row(idx)
        _close_dict(dict(trow), dict(jrow), scale)
        assert abs(tconst - jconst) <= RTOL * max(abs(jconst), scale)


# -- the analytic checks of tests/test_fd.py, on the port ----------------

def test_port_stencils_are_the_analytic_ones():
    h = 1.0 / 8
    rows, const = OPERATORS["first_derivative_central"](T).row((4,))
    got = {c[0]: v for c, v in rows}
    np.testing.assert_allclose([got[3], got[5]], [-1 / (2 * h), 1 / (2 * h)], rtol=1e-12)
    assert abs(got.get(4, 0.0)) < 1e-9 and const == 0.0
    rows, _ = OPERATORS["second_derivative_central"](T).row((4,))
    got = {c[0]: v for c, v in rows}
    np.testing.assert_allclose([got[3], got[4], got[5]], [1 / h**2, -2 / h**2, 1 / h**2],
                               rtol=1e-12)
    rows, _ = OPERATORS["derivative_periodic_wraps"](T).row((0,))
    assert 7 in [c[0] for c, _ in rows]


@pytest.mark.parametrize("case, f, df, sl", [
    ("derivative_none_bc_one_sided", lambda x: x**2, lambda x: 2 * x, slice(None)),
    ("derivative_dirichlet_bc", lambda x: x**2 - x + 2.0, lambda x: 2 * x - 1, slice(None)),
    ("derivative_neumann_bc", lambda x: x**2 + 3.0 * x, lambda x: 2.0 + 0 * x, slice(None)),
    ("composition_dxx_equals_dx_of_dx", lambda x: x**2, lambda x: 2.0 + 0 * x,
     slice(1, -1)),
    ("composition_const_flows_through", lambda x: x**2, lambda x: 2.0 + 0 * x,
     slice(None)),
])
def test_port_is_exact_on_quadratics(case, f, df, sl):
    op = OPERATORS[case](T)
    c = op.mesh.centers(0)
    out = op.apply(torch.from_numpy(f(c))).numpy()
    np.testing.assert_allclose(out[sl], df(c)[sl], atol=1e-7)


def test_laplace_solve_matches_reference():
    """test_fd.py's Dirichlet Laplace solve (BiCGStab to rtol 1e-10) with
    each package's operator and solver: the two solutions agree within
    1e-10, and the port's is second-order accurate."""
    jlap, tlap = build("laplace_solve_via_fd_operator")
    cx = tlap.mesh.centers(0)
    X, Y = np.meshgrid(cx, cx, indexing="ij")
    u_ex = np.sin(np.pi * X) * np.sin(np.pi * Y)
    rhs = -2.0 * np.pi**2 * u_ex
    want = np.asarray(jbicgstab(lambda w: jlap.apply(w, include_const=False),
                                jnp.asarray(rhs), rtol=1e-10, maxiter=2000).x)
    got = tbicgstab(lambda w: tlap.apply(w, include_const=False), torch.from_numpy(rhs),
                    rtol=1e-10, maxiter=2000).x.numpy()
    assert rel(got, want) <= 1e-10
    assert got.min() >= -1e-8 and got.max() <= 1.1
    assert np.max(np.abs(got - u_ex)) < 5e-3


def test_fd_from_options_builds_tvd_and_locations():
    m = mesh2d(T)
    assert T.fd.parse_loc("down_left", 2) == (True, True)
    assert T.fd.parse_loc("element", 2) == (False, False)
    tvd = T.fd.fd_from_options(m, TOptions({"flucafd_type": "secondordertvd",
                                            "flucafd_dir": "y",
                                            "flucafd_limiter": "minmod"}))
    assert isinstance(tvd, ttvd.TVDOp) and tvd.d == 1
    with pytest.raises(ValueError):
        T.fd.parse_loc("back", 2)
    with pytest.raises(ValueError):
        T.fd.fd_from_options(m, TOptions({"flucafd_type": "upwind"}))


def test_fourth_order_convergence():
    errs = []
    for N in (16, 32):
        op = T.fd.derivative(mesh1d(T, N), 0, 1, 4)
        c = op.mesh.centers(0)
        df = op.apply(torch.from_numpy(np.sin(2 * np.pi * c))).numpy()
        errs.append(np.max(np.abs(df - 2 * np.pi * np.cos(2 * np.pi * c))[3:-3]))
    assert errs[0] / errs[1] > 12.0


@pytest.mark.parametrize("case", ["derivative_dirichlet_bc", "sum_2d_laplacian",
                                  "composition_const_flows_through", "derivative_3d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_op_carried_from_reference(case, dtype):
    """fluca_tpu's operator carried across by its bands
    (stencil_op_from_numpy): the port's apply of it equals fluca_tpu's
    (1e-12 in float64; float32's own rounding, 1e-6, in float32), and
    equals the port's own operator of the same case."""
    jop, top = build(case)
    carried = stencil_op_from_numpy(top.mesh, {k: np.asarray(w) for k, w in jop.bands.items()},
                                    np.asarray(jop.const), jop.in_stag, jop.out_stag, "cpu",
                                    dtype)
    assert (torch.device("cpu"), dtype) in carried._on_device
    x = seeded_in(jop, seed=3)
    want = np.asarray(jop.apply(jnp.asarray(x)))
    got = carried.apply(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    assert rel(got.double().numpy(), want) <= (RTOL if dtype == F64 else 1e-6)
    assert rel(top.to_dense(), carried.to_dense()) <= RTOL


def test_operator_moves_its_bands_once_per_device_and_dtype():
    op = OPERATORS["sum_2d_laplacian"](T)
    x = torch.from_numpy(seeded_in(op))
    op.apply(x)
    bands = op._on_device[(torch.device("cpu"), F64)][0]
    op.apply(x)
    assert op._on_device[(torch.device("cpu"), F64)][0] is bands
    op.apply(x.float())
    assert len(op._on_device) == 2
