"""The turbulence statistics of the port's channel_turb and diag_turb128
scripts against the JAX scripts' (examples/channel_turb.py turb_stats,
examples/diag_turb128.py E_and_utau, imported by path) on the same
state, in float64 on the CPU, and the two checks of
tests/test_turb_stats.py on the port's turb_stats; then the port's run
loop, guards and command lines at a tiny size.

Both compute on the host in float64 numpy from the same arrays, so the
statistics agree to 1e-12 relative (the same operations in the same
order; the bound only allows for numpy's summation blocking)."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.models.channel import setup_channel_3d as j_channel3d
from fluca_tpu_torch.examples import channel_turb, diag_turb128
from fluca_tpu_torch.models.channel import setup_channel_3d as t_channel3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
RTOL = 1e-12


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pair(N=(16, 32, 16), **kw):
    """The same channel in both packages (their seeded initial states are
    equal, tests/test_torch_slice3d.py)."""
    args = dict(N=N, dt=1e-3, max_steps=2, stretch_y=2.0, **kw)
    return (j_channel3d(dtype=jnp.float64, **args),
            t_channel3d(device="cpu", dtype=F64, **args))


@pytest.mark.parametrize("mode", ["rolls", "noise"])
def test_turb_stats_matches_reference(mode):
    jns, tns = pair(perturb=0.2, perturb_mode=mode)
    E, ut, profs = jax_script("channel_turb").turb_stats(jns)
    tE, tut, tprofs = channel_turb.turb_stats(tns)
    assert E > 0 and abs(tE - E) <= RTOL * E
    assert abs(tut - ut) <= RTOL * ut
    assert set(tprofs) == set(profs) == {"U", "uv", "uu", "vv", "ww"}
    for k in profs:
        np.testing.assert_allclose(tprofs[k], profs[k], rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("mode", ["rolls", "noise"])
def test_E_and_utau_matches_reference(mode):
    jns, tns = pair(perturb=0.2, perturb_mode=mode)
    E, ut = jax_script("diag_turb128").E_and_utau(jns)
    tE, tut = diag_turb128.E_and_utau(tns)
    assert E > 0 and abs(tE - E) <= RTOL * E
    assert abs(tut - ut) <= RTOL * ut


def test_u_tau_of_laminar_profile():
    """For the laminar profile u = (Re_tau/2) u_tau (1 - ((y-d)/d)^2),
    du/dy at the wall is Re_tau u_tau / d, so tau_w = nu du/dy = u_tau^2
    exactly: the identity behind the forcing balance's u_tau = 1; the
    first-cell-centre difference recovers it to O(y1/delta)."""
    ns = t_channel3d(N=(16, 32, 16), dt=1e-3, max_steps=2, perturb=0.0, stretch_y=2.0,
                     device="cpu", dtype=F64)
    E, u_tau, profs = channel_turb.turb_stats(ns)
    assert E < 1e-20  # no fluctuations about the xz-mean
    assert abs(u_tau - 1.0) < 0.02, u_tau
    cy = np.asarray(ns.mesh.centers(1))
    np.testing.assert_allclose(profs["U"], 90.0 * (1.0 - (cy - 1.0) ** 2), rtol=1e-12)
    for key in ("uv", "uu", "vv", "ww"):
        assert float(np.abs(profs[key]).max()) < 1e-20, key


def test_fluctuation_energy_of_seeded_field():
    """E_turb measures energy about the xz-mean: a pure profile has none;
    a known sinusoidal fluctuation adds exactly its energy."""
    ns = t_channel3d(N=(16, 16, 16), dt=1e-3, max_steps=2, perturb=0.0, device="cpu",
                     dtype=F64)
    E0, _, _ = channel_turb.turb_stats(ns)
    assert E0 < 1e-20
    shape = ns.mesh.cell_shape
    x = np.arange(shape[0])
    pert = 0.3 * np.sin(2 * np.pi * x / shape[0])
    v = list(ns.state["v"])
    v[1] = v[1] + torch.from_numpy(np.broadcast_to(pert[:, None, None], shape).copy())
    ns.state["v"] = tuple(v)
    E1, _, _ = channel_turb.turb_stats(ns)
    np.testing.assert_allclose(E1, 0.5 * 0.09 / 2, rtol=1e-10)


@pytest.mark.parametrize("t, E, u_tau, verdict", [
    (0.5, 40.0, 1.8, None),
    (3.0, 2.0, 1.0, None),
    (0.1, float("nan"), 1.0, "DIVERGED"),
    (2.5, 1.0, 0.1, "COLLAPSED (u_tau"),
    (1.0, 1e-6, 0.1, None),          # before either collapse guard
    (1.6, 1e-6, 1.0, "COLLAPSED (E"),
])
def test_guards(t, E, u_tau, verdict):
    """The JAX script's three guards and their times."""
    got = channel_turb.guard(t, E, u_tau)
    assert got == verdict if verdict is None else got.startswith(verdict)


def test_run_loop_and_summary():
    """The loop at 8^3: a step, two chunks of two steps, a reading after
    each, the profile averaged from t_stats, no guard tripped; the
    summary has the JAX script's record keys."""
    ns = channel_turb.setup(8, 1e-3, device="cpu")
    lines = []
    series, acc, n, stop = channel_turb.run(ns, 4, 2, 0.0, log=lines.append)
    assert stop is None and n == 2 and len(series) == 2 and len(lines) == 2
    assert ns.step_index == 5
    assert all(np.isfinite(s["E_turb"]) and s["E_turb"] > 0 for s in series)
    out = channel_turb.summary(ns, 8, 1e-3, 0.004, series, acc, n)
    # the keys examples/channel_turb.py main writes; its configuration's
    # keys as in the reference's record CHANNEL_TURB.json
    assert set(out) == {"config", "series", "u_tau_final", "u_tau_target", "u_tau_rel_err",
                        "sustained", "mean_profile", "reynolds_stress"}
    assert set(out["reynolds_stress"]) == {"y", "uv_plus", "urms_plus", "vrms_plus",
                                           "wrms_plus"}
    with open(os.path.join(REPO, "CHANNEL_TURB.json")) as f:
        ref = json.load(f)
    assert set(out["config"]) == set(ref["config"])
    assert len(out["mean_profile"]["y_plus"]) == 4


def test_channel_turb_command_line(tmp_path, monkeypatch):
    monkeypatch.setattr(channel_turb, "CHUNK", 2)
    out = tmp_path / "turb.json"
    rc = channel_turb.main(["0.004", "1e-3", "--N", "8", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["stopped"] is None and len(rec["series"]) == 2
    assert rec["config"]["N"] == 8 and rec["device"]["platform"] == "cpu"


def test_diag_turb128_probe():
    """A probe at 8^3: the first step's achieved rtol (ksp_rnorm /
    ||rhs||) and a reading per chunk."""
    rec = diag_turb128.run("tolerance-1e-5", CNLinearConfig(), nsteps=2, chunk=1,
                           device="cpu", shape=(8, 8, 8))
    assert rec["step1_rel"] <= 1e-5 and len(rec["chunks"]) == 2
    assert [c[0] for c in diag_turb128.cases()] == ["production", "big-budgets",
                                                     "tolerance-1e-5"]
