"""The reference's accuracy contract in the port, against fluca_tpu in
float64 on the CPU: CNLinearConfig's fields and defaults, the warm-started
FGMRES outer (rtol 1e-5), the ||rhs|| diagnostic and the tolerance
script's rows.

Tolerance for states: ||port - ref|| <= 1e-10 * ||ref|| per field, as
tests/test_torch_slice.py: both run the same algorithm in float64 and
differ in summation order only (~1e-14 after a few steps); a different
initial guess or Krylov iterate shows at 1e-6 or more. The iteration
counts are equal and ||rhs|| agrees within 1e-12 relative (one norm of
the same right-hand side)."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.models.channel import setup_channel_3d as j_channel3d
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu.utils.options import Options as JOptions
from fluca_tpu_torch.examples import tolerance
from fluca_tpu_torch.interop import state_to_numpy
from fluca_tpu_torch.models.cavity import setup_cavity_2d as t_cavity
from fluca_tpu_torch.models.channel import setup_channel_3d as t_channel3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig
from fluca_tpu_torch.utils.options import Options as TOptions

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-10
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 3-D shapes avoid 4 along an axis: jaxlib 0.9.0's CPU jnp.pad of such
# float64 arrays corrupts the heap
CASES = {
    "cavity16": (lambda: j_cavity(N=16, Re=100.0, dt=0.01, max_steps=10**9),
                 lambda: t_cavity(N=16, Re=100.0, dt=0.01, max_steps=10**9, device="cpu",
                                  dtype=F64)),
    "channel8": (lambda: j_channel3d(N=(8, 8, 8), stretch_y=2.0, dt=2e-3, max_steps=10**9,
                                     dtype=jnp.float64),
                 lambda: t_channel3d(N=(8, 8, 8), stretch_y=2.0, dt=2e-3, max_steps=10**9,
                                     device="cpu", dtype=F64)),
}
STEPS = 3


def jax_state(ns):
    return {k: (tuple(np.asarray(x) for x in ns.state[k]) if k in ("v", "U")
                else np.asarray(ns.state[k])) for k in ("v", "U", "p", "phalf")}


def assert_states_close(tstate, jstate):
    got = state_to_numpy(tstate)
    for k in ("v", "U"):
        for g, w in zip(got[k], jstate[k]):
            assert np.linalg.norm(g - w) <= RTOL * np.linalg.norm(w), k
    for k in ("p", "phalf"):
        assert np.linalg.norm(got[k] - jstate[k]) <= RTOL * np.linalg.norm(jstate[k]), k


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("preset", ["default", "production", "production_fast",
                                    "from_options"])
def test_config_fields_and_defaults_match_reference(preset):
    """Every field of fluca_tpu's CNLinearConfig, in its order, with its
    default, in each preset; from_options reads none of warm_start,
    diag_rhs_norm and mg_levels, as fluca_tpu's does not."""
    make = {"default": lambda C, O: C(), "production": lambda C, O: C.production(),
            "production_fast": lambda C, O: C.production_fast(),
            "from_options": lambda C, O: C.from_options(O({"ns_warm_start": "1",
                                                            "ns_diag_rhs_norm": "1"}))}[preset]
    want = fields(make(JConfig, JOptions))
    got = fields(make(TConfig, TOptions))
    assert list(got) == list(want)
    assert got == want
    assert not got["warm_start"] and not got["diag_rhs_norm"] and got["mg_levels"]


def run_steps(ns, cfg, n=STEPS):
    """n steps through NS.step under cfg; each step's (ksp_iters,
    rhs_norm) from last_diag."""
    ns.impl.cfg = cfg
    out = []
    for _ in range(n):
        ns.step()
        d = ns.last_diag
        out.append((int(d["ksp_iters"]), float(d["rhs_norm"]), float(d["ksp_rnorm"])))
    return out


@pytest.fixture(scope="module")
def reference_runs():
    """fluca_tpu's steps under FGMRES rtol 1e-5 with ||rhs|| reported,
    cold and warm-started, on each case."""
    runs = {}
    for name, (jmake, _) in CASES.items():
        for warm in (False, True):
            ns = jmake()
            diags = run_steps(ns, JConfig(warm_start=warm, diag_rhs_norm=True))
            runs[name, warm] = (diags, jax_state(ns))
    return runs


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_fgmres_step_matches_reference(reference_runs, case, warm):
    """FGMRES rtol 1e-5 steps from the same state: the same outer
    iterations each step, ||rhs|| within 1e-12, the states within 1e-10;
    every step meets the contract, ksp_rnorm <= 1e-5 ||rhs||."""
    want_diags, want_state = reference_runs[case, warm]
    ns = CASES[case][1]()
    diags = run_steps(ns, TConfig(warm_start=warm, diag_rhs_norm=True))
    for (its, rhs, rn), (jits, jrhs, _) in zip(diags, want_diags):
        assert its == jits
        assert abs(rhs - jrhs) <= 1e-12 * jrhs
        assert rn <= 1e-5 * rhs
    assert_states_close(ns.state, want_state)


@pytest.mark.parametrize("case", list(CASES))
def test_warm_start_saves_outer_iterations(reference_runs, case):
    """Warm-starting the outer from the old velocities takes no more
    outer iterations in all than the zero guess, in both packages, and
    the two converged states agree to the solve's tolerance."""
    cold, warm = reference_runs[case, False], reference_runs[case, True]
    assert sum(d[0] for d in warm[0]) <= sum(d[0] for d in cold[0])
    ns = CASES[case][1]()
    run_steps(ns, TConfig(warm_start=True, diag_rhs_norm=True))
    got = state_to_numpy(ns.state)
    for g, w in zip(got["v"], cold[1]["v"]):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


def test_diag_rhs_norm_adds_exactly_the_key():
    """The flag adds "rhs_norm" to the step's diagnostics and changes
    nothing else: the same keys otherwise, the same state bit for bit."""
    a, b = CASES["cavity16"][1](), CASES["cavity16"][1]()
    a.impl.cfg = TConfig()
    b.impl.cfg = TConfig(diag_rhs_norm=True)
    a.step()
    b.step()
    assert set(b.last_diag) - set(a.last_diag) == {"rhs_norm"}
    assert set(a.last_diag) == {"ksp_iters", "ksp_rnorm", "converged"}
    for x, y in zip(state_to_numpy(a.state)["v"], state_to_numpy(b.state)["v"]):
        assert np.array_equal(x, y)
    jns = CASES["cavity16"][0]()
    jns.impl.cfg = JConfig(diag_rhs_norm=True)
    jns.step()
    assert set(jns.last_diag) == set(b.last_diag)


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_config_row_has_the_reference_keys():
    """tolerance.run_config on the CPU at 8x8x8: the JAX script's row
    keys (the port adds peak_mem_bytes on a card only), every step at or
    under rtol 1e-5."""
    kw = dict(nsteps=2, dt=2e-3)
    want = jax_script("tolerance").run_config((8, 8, 8), JConfig(), "tol", **kw)
    got = tolerance.run_config((8, 8, 8), TConfig(), "tol", device="cpu", **kw)
    assert "error" not in got and "error" not in want
    assert set(got) == set(want)
    assert all(float(r) <= 1e-5 for r in got["achieved_rtol_per_step"])
    assert got["outer_iters"] == want["outer_iters"]


def test_tolerance_rows_are_the_reference_rows():
    """The script's rows: the JAX script's labels in its order, the 512
    FGMRES row at the restart asked for (4 by default), and a path to
    the repo's TOLERANCE.json refused."""
    src = open(os.path.join(REPO, "examples", "tolerance.py")).read()
    rows = tolerance.rows()
    labels = [r[2] for r in rows]
    assert all(f'"{label}"' in src for label in labels if "_r4_" not in label)
    assert labels.index("tol1e-5_fgmres_r4_512") == 7
    (_, cfg, _, kw), = [r for r in tolerance.rows(restart=30) if "fgmres_r30" in r[2]]
    assert (cfg.restart, cfg.maxiter, kw["nsteps"]) == (30, 12, 3)
    assert [r[0] for r in rows].count((512, 256, 256)) == 7
    with pytest.raises(SystemExit):
        tolerance.main(["--out", os.path.join(REPO, "TOLERANCE.json"), "--device", "cpu"])
