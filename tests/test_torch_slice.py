"""The port's 2-D time step end to end against fluca_tpu in float64:
the lid-driven cavity under the reference's default solver and the
production preset, a run continued from a fluca_tpu mid-run state, the
Taylor-Green oracle, the app entry point, and the NS lifecycle.

Tolerance for states: ||port - ref|| <= 1e-10 * ||ref|| per field. Both
run the same algorithm in float64; they differ in summation order only
(the separable vs banded Poisson form, the stacked vs dict momentum
coefficients), which measures at ~1e-14 after 5 steps. A change of
algorithm (a wrong extrapolation branch, a missed projection, a
different Krylov iterate) shows at 1e-6 or more."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.models.tgv import setup_taylor_green_2d as j_tgv
from fluca_tpu.models.tgv import tgv_errors as j_tgv_errors
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu_torch import app
from fluca_tpu_torch.interop import state_from_numpy, state_to_numpy
from fluca_tpu_torch.models.cavity import setup_cavity_2d as t_cavity
from fluca_tpu_torch.models.tgv import setup_taylor_green_2d as t_tgv
from fluca_tpu_torch.models.tgv import tgv_errors as t_tgv_errors
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig
from fluca_tpu_torch.ns.ns import NSConvergedReason
from fluca_tpu_torch.ops import cuda_stencil

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-10
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_state(ns):
    return {
        "v": tuple(np.asarray(x) for x in ns.state["v"]),
        "U": tuple(np.asarray(x) for x in ns.state["U"]),
        "p": np.asarray(ns.state["p"]),
        "phalf": np.asarray(ns.state["phalf"]),
    }


def assert_states_close(tstate, jstate):
    got = state_to_numpy(tstate)
    for k in ("v", "U"):
        for g, w in zip(got[k], jstate[k]):
            assert np.linalg.norm(g - w) <= RTOL * np.linalg.norm(w), k
    for k in ("p", "phalf"):
        assert np.linalg.norm(got[k] - jstate[k]) <= RTOL * np.linalg.norm(jstate[k]), k


@pytest.fixture(scope="module")
def jax_default_run():
    """fluca_tpu's 32^2 cavity under its default solver: the state
    after 3 steps and after 5, with the last step's diagnostics."""
    ns = j_cavity(N=32, Re=100.0, dt=0.01, max_steps=3)
    ns.solve()
    mid = (jax_state(ns), ns.step_index, ns.t)
    ns.max_steps = 5
    ns.solve()
    return mid, jax_state(ns), int(ns.last_diag["ksp_iters"])


def test_cavity_default_solver_matches(jax_default_run):
    _, want, iters = jax_default_run
    ns = t_cavity(N=32, Re=100.0, dt=0.01, max_steps=5, device="cpu", dtype=F64)
    assert ns.solve() == NSConvergedReason.CONVERGED_ITS
    assert ns.last_diag["ksp_iters"] == iters
    assert_states_close(ns.state, want)


def test_cavity_continued_from_reference_state(jax_default_run):
    """Steps 4-5 from fluca_tpu's step-3 state: the later-step pressure
    extrapolation branch, entered with the reference's phalf."""
    (mid, step, t), want, _ = jax_default_run
    ns = t_cavity(N=32, Re=100.0, dt=0.01, max_steps=5, device="cpu", dtype=F64)
    ns.state = state_from_numpy(mid, "cpu", F64)
    ns.step_index, ns.t = step, t
    ns.solve()
    assert ns.step_index == 5
    assert_states_close(ns.state, want)


def test_cavity_production_preset_matches():
    jns = j_cavity(N=32, Re=100.0, dt=0.01, max_steps=5)
    jns.impl.cfg = JConfig.production()
    jns.solve()
    tns = t_cavity(N=32, Re=100.0, dt=0.01, max_steps=5, device="cpu", dtype=F64)
    tns.impl.cfg = TConfig.production()
    tns.solve()
    assert tns.last_diag["ksp_iters"] == 3
    rn, jrn = float(tns.last_diag["ksp_rnorm"]), float(jns.last_diag["ksp_rnorm"])
    assert abs(rn - jrn) <= 1e-8 * jrn
    assert_states_close(tns.state, jax_state(jns))


@pytest.mark.parametrize("periodic", [False, True])
def test_tgv_errors_match(periodic):
    """The analytic oracle: the port's errors against the exact TGV
    solution equal the reference's (relative 1e-8: the errors are
    differences of nearby numbers, ~1e-3 of the fields)."""
    jns = j_tgv(N=16, nsteps=4, t_final=0.25, periodic=periodic)
    jns.solve()
    tns = t_tgv(N=16, nsteps=4, t_final=0.25, periodic=periodic, device="cpu",
                dtype=F64)
    tns.solve()
    for got, want in zip(t_tgv_errors(tns), j_tgv_errors(jns)):
        assert abs(got - want) <= 1e-8 * want


def test_app_runs_on_cpu(capsys):
    rc = app.main(["-device", "cpu", "-cart_grid_x", "16", "-cart_grid_y", "16",
                   "-ns_max_steps", "3", "-ns_monitor", "-log_view"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "done: CONVERGED_ITS at step 3" in out
    assert "step 2  dt 0.002" in out and "ksp_its=" in out
    assert "NS_Step" in out and "NS_SetUp" in out


@pytest.mark.parametrize("option", [
    "checkpoint", "load_checkpoint", "mesh_cart_create_from_file",
    "ns_load_solution_from_file", "ns_view_solution",
])
def test_app_refuses_options_not_ported(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        app.main(["-device", "cpu", "-cart_grid_x", "8", f"-{option}", "x"])


def test_app_device_cuda_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(["-cart_grid_x", "8", "-cart_grid_y", "8", "-ns_max_steps", "1"])


def test_port_imports_no_jax():
    code = (
        "import sys, fluca_tpu_torch, fluca_tpu_torch.app, fluca_tpu_torch.interop;"
        "import fluca_tpu_torch.models, fluca_tpu_torch.solvers.mg;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fluca_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_torch_advance_chunks_match_steps():
    """advance() in monitor-interval chunks reaches the same state as
    step() calls, calls the monitors between chunks, and counts no
    kernel launch on the CPU."""
    a = t_cavity(N=16, Re=100.0, dt=0.02, max_steps=50, device="cpu", dtype=F64)
    b = t_cavity(N=16, Re=100.0, dt=0.02, max_steps=50, device="cpu", dtype=F64)
    a.impl.cfg = b.impl.cfg = TConfig.production()
    seen = []
    a.add_monitor(lambda ns: seen.append(ns.step_index))
    a.monitor_interval = 2
    before = [k.launches for k in cuda_stencil.KERNELS]
    a.advance(6)
    for _ in range(6):
        b.step()
    assert seen == [1, 3, 5]
    assert (a.step_index, a.t) == (6, pytest.approx(0.12))
    assert bool(a.last_diag["converged"])
    assert_states_close(a.state, state_to_numpy(b.state))
    assert [k.launches for k in cuda_stencil.KERNELS] == before


def test_torch_converged_reasons():
    ns = t_cavity(N=8, Re=100.0, dt=0.01, max_steps=None, device="cpu", dtype=F64)
    ns.max_time = 0.03
    assert ns.solve() == NSConvergedReason.CONVERGED_TIME and ns.step_index == 3

    bad = BoundaryCondition(BCType.VELOCITY,
                            velocity=lambda t, xs: (xs[0] * float("nan"), 0 * xs[0]))
    ns = t_cavity(N=8, Re=100.0, dt=0.01, max_steps=2, device="cpu", dtype=F64,
                  error_if_step_failed=False)
    ns.impl.ops.bcs[3] = bad
    assert ns.solve() == NSConvergedReason.DIVERGED_NONLINEAR_SOLVE
    assert ns.step_index == 0


def test_interop_round_trip_owns_its_storage():
    rng = np.random.default_rng(4)
    st = {"v": (rng.random((4, 5)), rng.random((4, 5))),
          "U": (rng.random((5, 5)), rng.random((4, 6))),
          "p": rng.random((4, 5)), "phalf": rng.random((4, 5))}
    t = state_from_numpy(st, "cpu", F64)
    ptrs = [x.data_ptr() for x in (*t["v"], *t["U"], t["p"], t["phalf"])]
    assert len(set(ptrs)) == 6
    back = state_to_numpy(t)
    for k in ("v", "U"):
        for a, b in zip(back[k], st[k]):
            assert np.array_equal(a, b)
    assert np.array_equal(back["p"], st["p"]) and np.array_equal(back["phalf"], st["phalf"])


def test_view_reports_solver():
    ns = t_cavity(N=8, Re=100.0, dt=0.01, device="cpu", dtype=F64)
    text = ns.view()
    assert "cnlinear" in text and "fgmres" in text and "device: cpu" in text
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        from fluca_tpu_torch.io.viewer import AsciiViewer

        AsciiViewer().write_solution(ns)
    assert buf.getvalue().startswith("step=0 t=0")
