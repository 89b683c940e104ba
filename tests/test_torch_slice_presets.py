"""The port's 32^2 cavity against fluca_tpu under the other solver
configurations of the 2-D step: the production_fast preset (GCR outer,
Jacobi momentum sweeps, MG-Richardson Schur), the fractional-step
method, and the ABF Atilde variants (FGMRES on the nonsymmetric Schur
complement).

Tolerance for states: ||port - ref|| <= 1e-10 * ||ref|| per field, for
the reason given in tests/test_torch_slice.py."""

import numpy as np
import pytest
import torch

from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu_torch.interop import state_to_numpy
from fluca_tpu_torch.models.cavity import setup_cavity_2d as t_cavity
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-10

CONFIGS = {
    "production_fast": lambda C: C.production_fast(),
    "fsm": lambda C: C(solve_type="fsm"),
    "ainv_diag_rowsum": lambda C: C(schur_ainv="diag", upper_ainv="rowsum"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cavity_preset_matches(name):
    jns = j_cavity(N=32, Re=100.0, dt=0.01, max_steps=5)
    jns.impl.cfg = CONFIGS[name](JConfig)
    jns.solve()
    tns = t_cavity(N=32, Re=100.0, dt=0.01, max_steps=5, device="cpu",
                   dtype=torch.float64)
    tns.impl.cfg = CONFIGS[name](TConfig)
    tns.solve()
    assert tns.step_index == jns.step_index == 5
    assert tns.last_diag["ksp_iters"] == int(jns.last_diag["ksp_iters"])
    got = state_to_numpy(tns.state)
    for k in ("v", "U"):
        for g, w in zip(got[k], jns.state[k]):
            w = np.asarray(w)
            assert np.linalg.norm(g - w) <= RTOL * np.linalg.norm(w), k
    for k in ("p", "phalf"):
        w = np.asarray(jns.state[k])
        assert np.linalg.norm(got[k] - w) <= RTOL * np.linalg.norm(w), k


def test_config_from_options_matches():
    from fluca_tpu.utils.options import Options as JOptions
    from fluca_tpu_torch.utils.options import Options as TOptions

    argv = ["-ns_ksp_type", "gcr", "-ns_ksp_max_it", "4",
            "-ns_abf_momentum_ksp_type", "jacobi", "-ns_abf_schur_ksp_type",
            "vcycle", "-ns_ksp_convergence_test_skip", "-ns_pc_abf_schur_ainv_type",
            "diag", "-ns_abf_schur_ksp_rtol", "1e-7"]
    j = JConfig.from_options(JOptions.from_argv(argv))
    t = TConfig.from_options(TOptions.from_argv(argv))
    for field in ("rtol", "restart", "maxiter", "mom_rtol", "mom_maxiter",
                  "schur_rtol", "schur_maxiter", "schur_ainv", "upper_ainv",
                  "solve_type", "outer_type", "mom_solver", "schur_solver",
                  "converged_skip"):
        assert getattr(t, field) == getattr(j, field), field
    for preset in ("production", "production_fast"):
        a, b = getattr(JConfig, preset)(), getattr(TConfig, preset)()
        assert (a.maxiter, a.mom_maxiter, a.schur_maxiter, a.outer_type,
                a.mom_solver, a.schur_solver) == (
            b.maxiter, b.mom_maxiter, b.schur_maxiter, b.outer_type,
            b.mom_solver, b.schur_solver)
