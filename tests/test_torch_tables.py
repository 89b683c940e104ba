"""fluca_tpu_torch host tables against fluca_tpu: the mesh, every
ns/tables.py table, compose_axis_stencils and the Poisson 2-D kernel
coefficients must be bit-identical (both are float64 numpy on the host,
built by the same formulas in the same order)."""

import itertools

import numpy as np
import pytest
import torch

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.ns import tables as JT
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JBCond
from fluca_tpu.ops.banded import compose_axis_stencils as j_compose
from fluca_tpu.ops.pallas_stencil import poisson2d_coeffs as j_poisson2d_coeffs
from fluca_tpu.solvers.mg import PoissonMG as JMG
from fluca_tpu.utils.options import Options as JOptions
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.ns import tables as TT
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TBCond
from fluca_tpu_torch.ops.banded import compose_axis_stencils as t_compose
from fluca_tpu_torch.ops.cuda_stencil import poisson2d_coeffs as t_poisson2d_coeffs
from fluca_tpu_torch.solvers.mg import PoissonMG as TMG
from fluca_tpu_torch.utils.options import Options as TOptions

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

WALLS = ("VELOCITY", "PRESSURE_OUTLET", "SYMMETRY")
# every (lo, hi) pair of the non-periodic types, plus periodic
AXIS_BCS = list(itertools.product(WALLS, WALLS)) + [("PERIODIC", "PERIODIC")]


def faces(N, stretched, seed):
    if not stretched:
        return np.linspace(0.0, 1.0, N + 1)
    rng = np.random.default_rng(seed)
    return np.concatenate([[0.0], np.cumsum(0.5 + rng.random(N))])


def meshes(N, periodic, stretched):
    f = [faces(N[d], stretched, 10 + d) for d in range(2)]
    out = []
    for M in (JMesh, TMesh):
        m = M.create(N, periodic)
        m.set_coordinates(*f)
        out.append(m)
    return out


def assert_stencil_equal(a, b):
    assert (a.axis, a.n_out, a.periodic) == (b.axis, b.n_out, b.periodic)
    assert [o for o, _ in a.bands] == [o for o, _ in b.bands]
    for (_, wa), (_, wb) in zip(a.bands, b.bands):
        assert np.array_equal(wa, wb)


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif hasattr(a, "bands"):
        assert_stencil_equal(a, b)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("periodic", [(False, False), (True, False)])
def test_mesh_matches(stretched, periodic):
    jm, tm = meshes((12, 9), periodic, stretched)
    assert (jm.N, jm.periodic, jm.dim) == (tm.N, tm.periodic, tm.dim)
    for d in range(2):
        assert jm.nfaces(d) == tm.nfaces(d)
        assert jm.face_shape(d) == tm.face_shape(d)
        for name in ("centers", "widths", "face_coords"):
            assert np.array_equal(getattr(jm, name)(d), getattr(tm, name)(d))
        assert jm.length(d) == tm.length(d)
    assert np.array_equal(jm.cell_volumes(), tm.cell_volumes())


def test_mesh_from_options_matches():
    argv = ["-cart_grid_x", "6", "-cart_grid_y", "10", "-cart_refine", "1",
            "-cart_boundary_type_y", "periodic", "-cart_xmax", "2.5"]
    jm = JMesh.from_options(JOptions.from_argv(argv))
    tm = TMesh.from_options(TOptions.from_argv(argv))
    assert (jm.N, jm.periodic) == (tm.N, tm.periodic) == ((12, 20), (False, True))
    for d in range(2):
        assert np.array_equal(jm.faces[d], tm.faces[d])


def test_mesh_zeros_take_device_and_dtype():
    m = TMesh.create((4, 6))
    m.set_uniform_coordinates(0, 1, 0, 1)
    z = m.zeros_face("cpu", torch.float64)
    assert [t.shape for t in z] == [(5, 6), (4, 7)]
    assert all(t.dtype == torch.float64 and t.device.type == "cpu" for t in z)
    v = m.zeros_cell_vector("cpu")
    assert v[0].dtype == torch.float32
    assert v[0].data_ptr() != v[1].data_ptr()  # no aliased state leaves


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("lo,hi", AXIS_BCS)
def test_tables_bit_identical(lo, hi, stretched):
    periodic = lo == "PERIODIC"
    jm, tm = meshes((10, 8), (periodic, periodic), stretched)
    jbc = JT.AxisBC(JBC[lo], JBC[hi])
    tbc = TT.AxisBC(TBC[lo], TBC[hi])
    for d in range(2):
        assert_tree_equal(JT.grad_cell_tables(jm, d, jbc),
                          TT.grad_cell_tables(tm, d, tbc))
        assert_tree_equal(JT.gst_tables(jm, d, jbc), TT.gst_tables(tm, d, tbc))
        assert_tree_equal(JT.div_tables(jm, d), TT.div_tables(tm, d))
        for comp in range(2):
            assert_tree_equal(JT.lap_tables(jm, d, jbc, comp),
                              TT.lap_tables(tm, d, tbc, comp))
            assert_tree_equal(JT.interp_tables(jm, d, jbc, comp),
                              TT.interp_tables(tm, d, tbc, comp))
        for normal in (False, True):
            assert_tree_equal(JT.conv_tables(jm, d, jbc, normal),
                              TT.conv_tables(tm, d, tbc, normal))


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("lo,hi", AXIS_BCS)
def test_compose_axis_stencils_bit_identical(lo, hi, stretched):
    periodic = lo == "PERIODIC"
    jm, tm = meshes((10, 8), (periodic, periodic), stretched)
    jbc = JT.AxisBC(JBC[lo], JBC[hi])
    tbc = TT.AxisBC(TBC[lo], TBC[hi])
    for d in range(2):
        # D@Gst (the Poisson operator) and T@G (the Rhie-Chow part)
        assert_stencil_equal(
            j_compose(JT.div_tables(jm, d), JT.gst_tables(jm, d, jbc)[0]),
            t_compose(TT.div_tables(tm, d), TT.gst_tables(tm, d, tbc)[0]),
        )
        assert_stencil_equal(
            j_compose(JT.interp_tables(jm, d, jbc, d)[0],
                      JT.grad_cell_tables(jm, d, jbc)[0]),
            t_compose(TT.interp_tables(tm, d, tbc, d)[0],
                      TT.grad_cell_tables(tm, d, tbc)[0]),
        )


def _bcs(kind, JC, TC_, JB, TB):
    def one(BC, Cond, name):
        if name == "PERIODIC":
            return Cond(BC.PERIODIC)
        if name == "VELOCITY":
            return Cond(BC.VELOCITY, velocity=lambda t, xs: (0 * xs[0], 0 * xs[0]))
        if name == "PRESSURE_OUTLET":
            return Cond(BC.PRESSURE_OUTLET, pressure=lambda t, xs: 0 * xs[0])
        return Cond(BC.SYMMETRY)

    return ([one(JB, JC, k) for k in kind], [one(TB, TC_, k) for k in kind])


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("kind", [
    ("VELOCITY",) * 4,
    ("PERIODIC",) * 4,
    ("VELOCITY", "PRESSURE_OUTLET", "SYMMETRY", "SYMMETRY"),
    ("PERIODIC", "PERIODIC", "SYMMETRY", "PRESSURE_OUTLET"),
])
def test_poisson2d_coeffs_bit_identical(kind, stretched):
    periodic = (kind[0] == "PERIODIC", kind[2] == "PERIODIC")
    jm, tm = meshes((32, 16), periodic, stretched)
    jbcs, tbcs = _bcs(kind, JBCond, TBCond, JBC, TBC)
    scale = 0.37
    jmg = JMG(jm, jbcs, scale=scale, dtype=np.float64)
    tmg = TMG(tm, tbcs, scale=scale, dtype=torch.float64, device="cpu")
    assert len(jmg.levels) == len(tmg.levels)
    for jl, tl in zip(jmg.levels, tmg.levels):
        want = j_poisson2d_coeffs(jl)
        got = t_poisson2d_coeffs(tl.mesh, tl.host_dgst, tl.host_vol)
        on_device = (tl.coeffs.rx, tl.coeffs.ry, tl.coeffs.cy, tl.coeffs.cyb)
        for w, g, dev in zip(want, got, on_device):
            assert np.array_equal(w, g)
            assert np.array_equal(w, dev.numpy())
        assert np.array_equal(np.asarray(jl.inv_diag), tl.inv_diag.numpy())
        assert np.array_equal(np.asarray(jl.vol), tl.vol.numpy())
    assert np.array_equal(np.asarray(jmg._coarse_pinv), tmg._coarse_pinv.numpy())
