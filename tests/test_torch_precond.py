"""The reduced-precision ABF preconditioner of the port
(``precond_dtype``, ``precond_scope``), on the CPU.

- The plumbing against fluca_tpu with ``precond_dtype="float32"`` under
  a float64 solve, scopes "both" and "mom", as the reference's own
  tests run it (tests/test_bf16_precond.py:51-76): the 16^2 cavity with
  production(3, 8, 6) and the stretched 8x8x8 channel with
  production(2, 4, 3), 5 steps, within 1e-5 * max|v| (cavity) and
  1e-4 * max|v| (channel), the reference's bounds for the same runs.
  Measured: 9.5e-11 (cavity) and 1.4e-8 (channel): the two packages
  run the same float32 inner solves in another summation order.
- The port's bf16 preconditioner under a float32 solve against its own
  float64 production run (the reference cannot compile bf16 on the
  CPU): the same two cases, and the channel with the solver that
  fluca_tpu ships for the 512x256x256 channel (production(2, 6, 8),
  Jacobi momentum, scope "mom"), within 5e-2 * max|v|. Measured: 1.3e-5
  (cavity, "both"), 1.9e-6 (cavity, "mom"), 3.7e-4 (channel, both
  scopes), 2.3e-4 (the shipped solver).
- The ``pre`` branch's chained ABF stages (3-D, one device) against its
  unfused ones, under the shipped solver.
- Tolerance-based inner solves are refused; the dtypes inside the
  ``pre`` branch of ``_abf_apply``.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.models.channel import setup_channel_3d as j_channel
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu_torch.interop import state_to_numpy
from fluca_tpu_torch.models.cavity import setup_cavity_2d as t_cavity
from fluca_tpu_torch.models.channel import setup_channel_3d as t_channel
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig
from fluca_tpu_torch.ops import chain3d

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
# case: (setup of each package, its arguments, production budget,
# bound on the float32-preconditioner deviation as a share of max|v|)
CASES = {
    "cavity": ((j_cavity, t_cavity), dict(N=16, Re=100.0, dt=0.01),
               (3, 8, 6), 1e-5),
    "channel": ((j_channel, t_channel), dict(N=(8, 8, 8), dt=1e-3, stretch_y=1.5),
                (2, 4, 3), 1e-4),
}
BF16_BOUND = 5e-2


def production(Config, case, precond=None, scope="both"):
    cfg = Config.production(*CASES[case][2])
    cfg.precond_dtype = precond
    cfg.precond_scope = scope
    return cfg


def shipped512(Config, precond=None):
    """fluca_tpu's solver for the 512x256x256 channel (bench.py:450-454)
    with its bf16 momentum preconditioner when ``precond`` is set."""
    cfg = Config.production(2, 6, 8)
    cfg.mom_solver = "jacobi"
    cfg.precond_dtype = precond
    cfg.precond_scope = "mom"
    return cfg


def port(case, cfg, dtype, nsteps=5):
    ns = CASES[case][0][1](max_steps=10**9, device="cpu", dtype=dtype,
                           **CASES[case][1])
    ns.impl.cfg = cfg
    ns.step()
    ns.advance(nsteps - 1)
    return ns


@functools.cache
def reference_f32_precond(case, scope):
    """fluca_tpu's velocity after 5 float64 steps with the float32
    preconditioner (built once per module)."""
    ns = CASES[case][0][0](max_steps=10**9, dtype=jnp.float64, **CASES[case][1])
    ns.impl.cfg = production(JConfig, case, "float32", scope)
    ns.step()
    ns.advance(4)
    return tuple(np.asarray(x) for x in ns.state["v"])


def max_dev(ns, want):
    got = state_to_numpy(ns.state)["v"]
    scale = max(np.abs(w).max() for w in want)
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("scope", ["both", "mom"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_precond_matches_reference(case, scope):
    want = reference_f32_precond(case, scope)
    ns = port(case, production(TConfig, case, "float32", scope), F64)
    assert all(x.dtype == F64 for x in ns.state["v"])
    assert ns.impl._pre16["dtype"] == F32
    assert (ns.impl._pre16["mg"] is None) == (scope == "mom")
    assert max_dev(ns, want) <= CASES[case][3]


@pytest.mark.parametrize("dtype,precond", [(F32, "bfloat16"), (F64, "float32")])
def test_pre_branch_chain_matches_unfused(dtype, precond):
    """The reduced-precision branch with the chain's ABF stages against
    the same branch on the banded operators (``UnfusedChain`` for every
    stage), 5 steps of the stretched 8x8x8 channel under the shipped
    solver. The gap, as a share of max|v|, is held to 4x the step's own
    one-rounding spread: the unfused run from a v0 moved by one unit in
    the last place. Measured: 2.0e-5 against a spread of 6.3e-5 (float32
    with bf16), 1.4e-16 against 2.7e-16 (float64 with float32)."""
    def run(unfused=False, ulp=False):
        ns = solver("channel", shipped512(TConfig, precond), dtype)
        assert isinstance(ns.impl._stages, chain3d.Chain3D)
        if unfused:
            ns.impl._stages = ns.impl._unfused
        if ulp:
            up = tuple(torch.nextafter(x, torch.full_like(x, math.inf))
                       for x in ns.state["v"])
            ns.state = {**ns.state, "v": up}
        ns.step()
        ns.advance(4)
        return ns

    unfused = run(unfused=True)
    want = state_to_numpy(unfused.state)["v"]
    spread = max_dev(run(unfused=True, ulp=True), want)
    assert 0 < spread
    assert max_dev(run(), want) <= 4 * spread


@functools.cache
def port_f64(case, shipped=False):
    cfg = shipped512(TConfig) if shipped else production(TConfig, case)
    return tuple(x.numpy() for x in port(case, cfg, F64).state["v"])


@pytest.mark.parametrize("case,scope,shipped", [
    ("cavity", "both", False), ("cavity", "mom", False),
    ("channel", "both", False), ("channel", "mom", False),
    ("channel", "mom", True),
])
def test_bf16_precond_close_to_f64(case, scope, shipped):
    cfg = (shipped512(TConfig, "bfloat16") if shipped
           else production(TConfig, case, "bfloat16", scope))
    ns = port(case, cfg, F32)
    assert all(bool(torch.isfinite(x).all()) for x in ns.state["v"])
    assert max_dev(ns, port_f64(case, shipped)) <= BF16_BOUND


def solver(case, cfg, dtype=F32):
    ns = CASES[case][0][1](max_steps=10**9, device="cpu", dtype=dtype,
                           **CASES[case][1])
    ns.impl.cfg = cfg
    return ns


def test_precond_requires_fixed_budget():
    """Tolerance-based inner solves cannot run in reduced precision
    (tests/test_precond_tiling.py:165-178); the Schur solve may keep a
    tolerance when it stays in the solver dtype (scope "mom")."""
    cfg = TConfig()  # the reference's tolerance-based defaults
    cfg.precond_dtype = "bfloat16"
    ns = solver("channel", cfg)
    with pytest.raises(ValueError, match="fixed-budget"):
        ns.impl._pre_resources()
    with pytest.raises(ValueError, match="fixed-budget"):
        ns.step()
    cfg = production(TConfig, "channel", "bfloat16", "both")
    cfg.schur_rtol = 1e-5
    with pytest.raises(ValueError, match="fixed-budget"):
        solver("channel", cfg).impl._pre_resources()
    cfg.precond_scope = "mom"
    assert solver("channel", cfg).impl._pre_resources()["mg"] is None
    cfg.precond_scope = "pressure"
    with pytest.raises(ValueError, match="precond_scope"):
        solver("channel", cfg).impl._pre_resources()


@pytest.mark.parametrize("case,scope,shipped", [
    ("cavity", "both", False), ("channel", "both", False),
    ("channel", "mom", True),
])
def test_pre_branch_dtypes(case, scope, shipped, monkeypatch):
    """bf16 iterates, float32 kernel coefficients, and the outer state
    in the solver dtype: a float32 or float64 tensor meeting a bf16 one
    would promote the inner solve out of bf16 without an error."""
    cfg = (shipped512(TConfig, "bfloat16") if shipped
           else production(TConfig, case, "bfloat16", scope))
    ns = solver(case, cfg)
    impl = ns.impl
    seen = {"mom": 0, "schur": 0, "abf": 0}
    mom, schur, abf = impl._solve_momentum, impl._solve_schur, impl._abf_apply

    def check_mom(rhs_v, Acoeffs, diagA):
        assert {x.dtype for x in (*rhs_v, *diagA)} == {BF16}
        if impl.ops.dim == 2:
            assert Acoeffs.dtype == BF16
        else:
            bands = impl.ops.momentum_bands_3d(Acoeffs.U0[0].dtype)
            assert {B.dtype for B in bands.b} == {F32}
            assert {F.dtype for F in (*Acoeffs.U0, *sum(Acoeffs.v0f, ()))} == {BF16}
        assert {x.dtype for x in impl.ops.apply_A_coeffs(rhs_v, Acoeffs)} == {BF16}
        out = mom(rhs_v, Acoeffs, diagA)
        assert {x.dtype for x in out} == {BF16}
        seen["mom"] += 1
        return out

    def check_schur(rhs_p, ainv1=None, mg=None):
        out = schur(rhs_p, ainv1, mg)
        if scope == "both":
            assert rhs_p.dtype == out.dtype == BF16 and mg is not impl.mg
            for lvl in mg.levels:
                coef = lvl.coeffs.ry if impl.ops.dim == 2 else lvl.coeffs.a0
                assert coef.dtype == F32
                assert (lvl.vol.dtype, lvl.inv_diag.dtype) == (BF16, BF16)
            assert mg._coarse_pinv.dtype == BF16
        else:
            assert rhs_p.dtype == out.dtype == F32 and mg is None
        seen["schur"] += 1
        return out

    def check_abf(r, Acoeffs, diagA, pre=None):
        assert pre is not None and pre["dtype"] == BF16
        out = abf(r, Acoeffs, diagA, pre)
        assert {x.dtype for x in (*out["v"], *out["U"], out["p"])} == {F32}
        seen["abf"] += 1
        return out

    monkeypatch.setattr(impl, "_solve_momentum", check_mom)
    monkeypatch.setattr(impl, "_solve_schur", check_schur)
    monkeypatch.setattr(impl, "_abf_apply", check_abf)
    ns.step()
    assert seen["abf"] == cfg.maxiter and seen["mom"] == seen["schur"] == cfg.maxiter
    st = ns.state
    assert {x.dtype for x in (*st["v"], *st["U"], st["p"], st["phalf"])} == {F32}
    assert ns.last_diag["ksp_rnorm"].dtype == F32
    assert impl.mg.levels[0].vol.dtype == F32
