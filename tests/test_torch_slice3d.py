"""The port's 3-D time step end to end against fluca_tpu in float64: the
3-D lid-driven cavity (SYMMETRY back plane) under the reference's
default solver and the production preset, a run continued from a
fluca_tpu mid-run state, the wall-clustered channel with its body
force, the channel's initial conditions, the 2-D Poiseuille channel
(PRESSURE_OUTLET), and the app with -cart_dim 3.

Tolerance for states: ||port - ref|| <= 1e-10 * ||ref|| per field, as
tests/test_torch_slice.py, with the velocity v and the face velocity U
each taken as one vector over its components (a component that is
~1e-6 of the others, as w early in the cavity or v in the Poiseuille
channel, carries the others' roundoff). The two run the same algorithm
in float64, differing in summation order only (the separable vs banded
Poisson form, the fused vs banded momentum form): ~4e-13 after 3 steps.
A change of algorithm shows at 1e-6 or more. Initial conditions must
be bit-identical.

The cavity is 8x8x8, not 8x8x4: on jaxlib 0.9.0's CPU backend,
``jnp.pad`` of an (8, 8, 4) float64 array along axis 1 (the y face
arrays of an 8x8x4 grid) corrupts the heap, and the reference's own
8x8x4 default-solver run then differs by up to 1.7e-7 from one process
to the next; at 8x8x8 it is reproducible."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluca_tpu.models.cavity import setup_cavity_3d as j_cavity3d
from fluca_tpu.models.channel import setup_channel_2d as j_channel2d
from fluca_tpu.models.channel import setup_channel_3d as j_channel3d
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu_torch import app
from fluca_tpu_torch.interop import state_from_numpy, state_to_numpy
from fluca_tpu_torch.models import setup_cavity_3d as t_cavity3d
from fluca_tpu_torch.models import setup_channel_2d as t_channel2d
from fluca_tpu_torch.models import setup_channel_3d as t_channel3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig
from fluca_tpu_torch.ns.ns import NSConvergedReason
from fluca_tpu_torch.ops import cuda_stencil

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-10
F64 = torch.float64
CAVITY = dict(N=(8, 8, 8), Re=100.0, dt=0.01)
CHANNEL = dict(N=(8, 16, 8), stretch_y=2.0, dt=2e-3)


def jax_state(ns):
    return {
        "v": tuple(np.asarray(x) for x in ns.state["v"]),
        "U": tuple(np.asarray(x) for x in ns.state["U"]),
        "p": np.asarray(ns.state["p"]),
        "phalf": np.asarray(ns.state["phalf"]),
    }


def norm(arrays):
    return np.sqrt(sum(np.sum(a * a) for a in arrays))


def assert_states_close(tstate, jstate, rtol=RTOL):
    got = state_to_numpy(tstate)
    for k in ("v", "U"):
        assert len(got[k]) == len(jstate[k])
        diff = [g - w for g, w in zip(got[k], jstate[k])]
        assert norm(diff) <= rtol * norm(jstate[k]), k
    for k in ("p", "phalf"):
        assert np.linalg.norm(got[k] - jstate[k]) <= rtol * np.linalg.norm(jstate[k]), k


@pytest.fixture(scope="module")
def jax_cavity3d_run():
    """fluca_tpu's 8x8x8 cavity under its default solver: the state
    after 2 steps and after 3, with the last step's iterations."""
    ns = j_cavity3d(max_steps=2, dtype=jnp.float64, **CAVITY)
    ns.solve()
    mid = (jax_state(ns), ns.step_index, ns.t)
    ns.max_steps = 3
    ns.solve()
    return mid, jax_state(ns), int(ns.last_diag["ksp_iters"])


def test_cavity3d_default_solver_matches(jax_cavity3d_run):
    _, want, iters = jax_cavity3d_run
    ns = t_cavity3d(max_steps=3, device="cpu", dtype=F64, **CAVITY)
    assert ns.mesh.dim == 3 and [b.type.value for b in ns.bcs][3:5] == \
        ["velocity", "symmetry"]
    assert ns.solve() == NSConvergedReason.CONVERGED_ITS
    assert ns.last_diag["ksp_iters"] == iters
    assert_states_close(ns.state, want)


def test_cavity3d_continued_from_reference_state(jax_cavity3d_run):
    """Step 3 from fluca_tpu's step-2 state: the later-step pressure
    extrapolation branch, entered with the reference's phalf."""
    (mid, step, t), want, iters = jax_cavity3d_run
    ns = t_cavity3d(max_steps=3, device="cpu", dtype=F64, **CAVITY)
    ns.state = state_from_numpy(mid, "cpu", F64)
    ns.step_index, ns.t = step, t
    ns.solve()
    assert ns.step_index == 3 and ns.last_diag["ksp_iters"] == iters
    assert_states_close(ns.state, want)


def test_cavity3d_production_preset_matches():
    jns = j_cavity3d(max_steps=3, dtype=jnp.float64, **CAVITY)
    jns.impl.cfg = JConfig.production()
    jns.solve()
    tns = t_cavity3d(max_steps=3, device="cpu", dtype=F64, **CAVITY)
    tns.impl.cfg = TConfig.production()
    before = [k.launches for k in cuda_stencil.KERNELS]
    tns.solve()
    assert [k.launches for k in cuda_stencil.KERNELS] == before
    assert tns.last_diag["ksp_iters"] == 3
    rn, jrn = float(tns.last_diag["ksp_rnorm"]), float(jns.last_diag["ksp_rnorm"])
    assert abs(rn - jrn) <= 1e-8 * jrn
    assert_states_close(tns.state, jax_state(jns))


def test_channel3d_stretched_production_matches():
    """The wall-clustered channel (periodic x and z, tanh-stretched y)
    driven by the mean-pressure-gradient body force."""
    jns = j_channel3d(max_steps=3, dtype=jnp.float64, **CHANNEL)
    jns.impl.cfg = JConfig.production()
    jns.solve()
    tns = t_channel3d(max_steps=3, device="cpu", dtype=F64, **CHANNEL)
    tns.impl.cfg = TConfig.production()
    assert tns.impl.body_force is not None
    tns.solve()
    assert tns.last_diag["ksp_iters"] == int(jns.last_diag["ksp_iters"])
    assert_states_close(tns.state, jax_state(jns))


def test_channel3d_body_force_drives_the_flow():
    """Without the hook the same steps give another state: the force is
    part of what the comparison above checks."""
    a = t_channel3d(max_steps=1, device="cpu", dtype=F64, **CHANNEL)
    b = t_channel3d(max_steps=1, device="cpu", dtype=F64, **CHANNEL)
    a.impl.cfg = b.impl.cfg = TConfig.production()
    b.impl.body_force = None
    a.solve()
    b.solve()
    du = (a.state["v"][0] - b.state["v"][0]).mean()
    # the force adds dt * f_x = 2e-3 to the mean streamwise velocity
    assert float(du) == pytest.approx(2e-3, rel=1e-2)


@pytest.mark.parametrize("mode", ["noise", "rolls"])
def test_channel3d_initial_conditions_equal(mode):
    jns = j_channel3d(perturb_mode=mode, dtype=jnp.float64, **CHANNEL)
    tns = t_channel3d(perturb_mode=mode, device="cpu", dtype=F64, **CHANNEL)
    got, want = state_to_numpy(tns.state), jax_state(jns)
    for k in ("v", "U"):
        for g, w in zip(got[k], want[k]):
            assert np.array_equal(g, w), k
    for k in ("p", "phalf"):
        assert np.array_equal(got[k], want[k]), k
    np.testing.assert_array_equal(tns.mesh.faces[1], jns.mesh.faces[1])
    ptrs = [x.data_ptr() for x in (*tns.state["v"], *tns.state["U"])]
    assert len(set(ptrs)) == 6
    with pytest.raises(ValueError, match="perturb_mode"):
        t_channel3d(perturb_mode="waves", device="cpu", dtype=F64, **CHANNEL)


def test_channel2d_poiseuille_matches():
    """The 2-D PRESSURE_OUTLET channel on the 2-D kernels' plain
    versions, from the exact solution, under the default solver."""
    jns = j_channel2d(N=(16, 8), max_steps=3, dtype=jnp.float64)
    jns.solve()
    tns = t_channel2d(N=(16, 8), max_steps=3, device="cpu", dtype=F64)
    assert tns.state["p"].data_ptr() != tns.state["phalf"].data_ptr()
    assert tns.solve() == NSConvergedReason.CONVERGED_ITS
    assert tns.last_diag["ksp_iters"] == int(jns.last_diag["ksp_iters"])
    assert_states_close(tns.state, jax_state(jns))


def test_app_3d_runs_on_cpu(capsys):
    rc = app.main(["-device", "cpu", "-cart_dim", "3", "-cart_grid_x", "8",
                   "-cart_grid_y", "8", "-cart_grid_z", "4", "-ns_max_steps", "2",
                   "-ns_monitor"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "done: CONVERGED_ITS at step 2" in out
    assert "ksp_its=" in out
