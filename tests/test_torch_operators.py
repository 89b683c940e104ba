"""fluca_tpu_torch NS operators against fluca_tpu in float64: every
apply_*, every bc_* vector, diag_A and the momentum coefficient fields
(dict and stacked) on the same mesh, boundary conditions and random
fields.

Tolerance: ||port - ref|| <= 1e-12 * ||ref|| per output leaf. Both
apply the same float64 tables with the same formulas; they differ only
in the order of a few additions (unit roundoff 1.1e-16), so 1e-12
leaves room while any wrong coefficient, offset or boundary row shows
at 1e-3 or more."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JCond
from fluca_tpu.ns.operators import NSOperators as JOps
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TCond
from fluca_tpu_torch.ns.operators import NSOperators as TOps

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-12
F64 = torch.float64

# boundary callbacks in plain arithmetic, so the same lambda serves
# jax arrays and torch tensors
VEL = lambda t, xs: (xs[0] * xs[1] + 1.0 + t, xs[0] - 2.0 * xs[1] * t)  # noqa: E731
PRES = lambda t, xs: 0.5 * xs[0] + 3.0 * xs[1] + t  # noqa: E731

CASES = {
    "cavity": ("VELOCITY",) * 4,
    "periodic": ("PERIODIC",) * 4,
    "mixed": ("VELOCITY", "PRESSURE_OUTLET", "SYMMETRY", "VELOCITY"),
    "channel": ("PERIODIC", "PERIODIC", "VELOCITY", "SYMMETRY"),
    "outlets": ("PRESSURE_OUTLET", "SYMMETRY", "PRESSURE_OUTLET", "VELOCITY"),
}


def make_bc(BC, Cond, name):
    if name == "VELOCITY":
        return Cond(BC.VELOCITY, velocity=VEL)
    if name == "PRESSURE_OUTLET":
        return Cond(BC.PRESSURE_OUTLET, pressure=PRES)
    return Cond(BC[name])


def build(case, stretched=True, N=(12, 10)):
    kind = CASES[case]
    periodic = (kind[0] == "PERIODIC", kind[2] == "PERIODIC")
    rng = np.random.default_rng(7)
    f = [
        np.concatenate([[0.0], np.cumsum(0.6 + rng.random(n))])
        if stretched else np.linspace(0.0, 1.0, n + 1)
        for n in N
    ]
    out = []
    for M, BC, Cond, Ops, kw in (
        (JMesh, JBC, JCond, JOps, {"dtype": jnp.float64}),
        (TMesh, TBC, TCond, TOps, {"dtype": F64, "device": "cpu"}),
    ):
        m = M.create(N, periodic)
        m.set_coordinates(*f)
        bcs = [make_bc(BC, Cond, k) for k in kind]
        out.append(Ops(m, bcs, 1.3, 0.07, 0.02, **kw))
    return out


def fields(ops, seed):
    """Random cell vector, face scalar, face vector and cell scalar as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    m = ops.mesh
    v = tuple(rng.standard_normal(m.cell_shape) for _ in range(2))
    U = tuple(rng.standard_normal(m.face_shape(d)) for d in range(2))
    vf = tuple(tuple(rng.standard_normal(m.face_shape(d)) for _ in range(2))
               for d in range(2))
    p = rng.standard_normal(m.cell_shape)
    return v, U, vf, p


def to_j(tree):
    if isinstance(tree, tuple):
        return tuple(to_j(x) for x in tree)
    return jnp.asarray(tree)


def to_t(tree):
    if isinstance(tree, tuple):
        return tuple(to_t(x) for x in tree)
    return torch.tensor(tree, dtype=F64)


def assert_close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w)
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_close(got[k], want[k])
        return
    w = np.broadcast_to(np.asarray(want), tuple(got.shape))
    g = got.numpy()
    err = np.linalg.norm(g - w)
    assert err <= RTOL * max(np.linalg.norm(w), 1e-300), (err, np.linalg.norm(w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_operators_match(case):
    jo, to = build(case)
    v, U, vf, p = fields(jo, 1)
    jv, jU, jvf, jp = to_j(v), to_j(U), to_j(vf), to_j(p)
    tv, tU, tvf, tp = to_t(v), to_t(U), to_t(vf), to_t(p)
    assert_close(to.apply_G(tp), jo.apply_G(jp))
    assert_close(to.apply_L(tv), jo.apply_L(jv))
    assert_close(to.apply_C(tv, tU, tvf), jo.apply_C(jv, jU, jvf))
    assert_close(to.apply_A(tv, tU, tvf), jo.apply_A(jv, jU, jvf))
    assert_close(to.apply_B(tv), jo.apply_B(jv))
    assert_close(to.apply_T(tv), jo.apply_T(jv))
    assert_close(to.apply_Gst(tp), jo.apply_Gst(jp))
    assert_close(to.apply_D(tU), jo.apply_D(jU))
    assert_close(to.apply_R(tp), jo.apply_R(jp))
    assert_close(to.apply_DGst(tp), jo.apply_DGst(jp))
    assert_close(to.diag_A(tU, tvf), jo.diag_A(jU, jvf))
    assert_close(to.diag_L, jo.diag_L)
    assert to.has_pressure_outlet == jo.has_pressure_outlet


@pytest.mark.parametrize("t", [0.0, 0.35])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bc_vectors_match(case, t):
    jo, to = build(case)
    tj = jnp.asarray(t)
    assert_close(to.bc_G(t), jo.bc_G(tj))
    assert_close(to.bc_L(t), jo.bc_L(tj))
    assert_close(to.bc_C(t, t + 0.02), jo.bc_C(tj, tj + 0.02))
    assert_close(to.bc_B(t), jo.bc_B(tj))
    assert_close(to.bc_T(t), jo.bc_T(tj))
    assert_close(to.bc_Gst(t), jo.bc_Gst(tj))


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_momentum_coeffs_and_stack_match(case, stretched):
    jo, to = build(case, stretched=stretched)
    _, U, vf, _ = fields(jo, 2)
    v, *_ = fields(jo, 3)
    jU, jvf, tU, tvf = to_j(U), to_j(vf), to_t(U), to_t(vf)
    jd, td = jo.build_momentum_coeffs(jU, jvf), to.build_momentum_coeffs(tU, tvf)
    for kind in ("self", "cross"):
        for c in range(2):
            for d in range(2):
                assert_close(td[kind][c][d], jd[kind][c][d])
    W = to.build_momentum_coeffs_stacked(tU, tvf)
    assert W.shape == (26, *to.mesh.cell_shape) and W.is_contiguous()
    assert_close(W, jo.build_momentum_coeffs_stacked(jU, jvf))
    # the stacked apply (the momentum kernel's plain version on the CPU)
    # is the reference's banded A
    assert_close(to.apply_A_coeffs(to_t(v), W),
                 jo.apply_A(to_j(v), jU, jvf))
