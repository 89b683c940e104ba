"""Smoke test of fluca_tpu_torch on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase; exits non-zero on any failure
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of 3 steps
                                     # of the 2-D cavity, 3-D cavity and channel

Phases:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the CUDA kernels from fluca_tpu_torch/csrc, one nvcc
     process per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card,
     float32 and float64: the 2-D Poisson modes on every multigrid level of
     the 256^2 and 1024^2 cavities (wall and periodic), the 2-D momentum
     kernel on the planes of real cavity and Taylor-Green steps; the 3-D
     Poisson modes on every level of the 64x64x32 cavity and the stretched
     128^3 channel, the 3-D momentum kernel on the factors of real cavity
     and channel steps and on random factors with PRESSURE_OUTLET and
     SYMMETRY boundaries;
  4. time: device time (CUDA graph) and eager time of each kernel and its
     plain version, 2-D at 256^2 and 4096^2, 3-D at 128^3;
  5. slice 2-D: the 256^2 Re 100 lid-driven cavity with the fixed-budget
     production solver, one step and advance(20), with the 2-D kernels'
     launch counts; then 5 steps against the plain float64 run on the CPU;
  6. app 2-D: the CLI entry point with the reference's FGMRES rtol 1e-5
     solver;
  7. slice 3-D: the 64x64x32 cavity (SYMMETRY back plane), step and
     advance(20), with the 3-D kernels' launch counts, and the 128^3
     channel (its residual and mean-flow retention printed, not gated,
     as bench.py does), both production; 5 cavity steps against the
     plain float64 run on the CPU;
  8. channel 512: the wall-clustered 512x256x256 channel (BASELINE config
     #5) at full size, 92 steps, gated as bench.py gates it: finite fields,
     mean-flow retention >= 0.9 after 11 steps, ksp_rnorm <= 500 over
     steps 73-92 (steps/s over those 20); then the 3-D kernels against
     their plain versions at its shapes (the Poisson modes on every
     multigrid level, the momentum kernel on the step's factors; float32
     and float64) and their times at 512x256x256;
  9. app 3-D: the CLI entry point at 64^3 with -cart_dim 3.
It prints the kernels' JSON summary, then the card's name and power limit
as nvidia-smi gives them, and last {"ok": true, "device": ...}.

Imports nothing of JAX: the card's machine has none.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

from fluca_tpu_torch import app
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.models.cavity import setup_cavity_2d, setup_cavity_3d
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.models.tgv import setup_taylor_green_2d
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.operators import NSOperators
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.solvers import mg as mg_mod

# Kernel vs plain version, as ||kernel - plain||_2 / ||plain||_2. Each
# output is a sum of 6 (Poisson) to 14 (momentum) products taken in
# another order, with fused multiply-adds, than the plain version's:
# a few units of roundoff per element, ~1e-7 (f32) and ~1e-16 (f64).
# The bounds leave a factor of ~100; a wrong coefficient, offset or
# boundary read gives O(1e-2) or more.
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}
# 5 fixed-budget cavity steps at 256^2, float32 on the card vs float64
# on the CPU, as ||a - b||_2 / ||b||_2. The same comparison on the CPU
# (float32 vs float64) gives 4e-5 for v and 1.8e-4 for p; the card sums
# in another order, so the bounds leave a factor of 25. A defect in a
# kernel or an operator gives O(1e-2) or more.
SLICE_RTOL = {"v": 1e-3, "p": 5e-3}
# 5 fixed-budget 64x64x32 cavity steps, float32 on the card vs float64 on
# the CPU, as the relative norm over the velocity vector and over p. The
# same comparison on the CPU (float32 vs float64) gives 2.0e-7 for v and
# 1.2e-6 for p; the bounds leave a factor of 25, as SLICE_RTOL does.
SLICE3D_RTOL = {"v": 5e-6, "p": 3e-5}
# The BASELINE #5 channel's solve-quality gates (bench.py:52-53, 474-480).
RETENTION_MIN = 0.9
RNORM_MAX = 500.0


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, iters=200, warmup=10) -> float:
    """Mean time of one eager fn() call in ms, by CUDA events around
    ``iters`` back-to-back calls. Where the host takes longer to issue a
    call than the device takes to run it, this is the host's time per
    call, which is what the eager main path pays."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=50, replays=20) -> float:
    """Device time of one fn() call in ms: ``calls`` calls captured in
    a CUDA graph, replayed ``replays`` times between CUDA events, so
    no host time is counted."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def assert_finite(ns, what):
    st = ns.state
    for name, leaf in (*((f"v{c}", x) for c, x in enumerate(st["v"])),
                       *((f"U{d}", x) for d, x in enumerate(st["U"])),
                       ("p", st["p"]), ("phalf", st["phalf"])):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"non-finite {name} in {what}")


def timed_run(ns, n):
    """One step, then advance(n), between synchronisations; returns
    (first-step s, advance s, launches by kernel)."""
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    ns.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ns.advance(n)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k.name: k.launches for k in cuda_stencil.KERNELS}
    return t1 - t0, t2 - t1, launches


def require_launches(launches, names, what):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by {what}")


def cavity_bcs():
    wall = zero_velocity_bc()
    lid = BoundaryCondition(
        BCType.VELOCITY, velocity=lambda t, xs: (1.0 + 0.0 * xs[0], 0.0 * xs[0])
    )
    return [wall, wall, wall, lid]


def unit_mesh(N, periodic):
    m = CartMesh.create((N, N), (periodic, periodic))
    m.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    return m


def bcs_for(periodic):
    return [BoundaryCondition(BCType.PERIODIC)] * 4 if periodic else cavity_bcs()


# ----------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = cuda_stencil.build_library()
    cuda_stencil.load_library()
    print(f"[build] {lib} in {time.perf_counter() - t0:.2f} s", flush=True)


def step_v0f(ops, state, t):
    """v0f = B v0 + bcB(t), as the step forms it."""
    Bv0 = ops.apply_B(state["v"])
    bcB = ops.bc_B(t)
    return tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(ops.dim))
                 for d in range(ops.dim))


def check_kernel(results, label, dtype, got, ref):
    for g, r in zip(got, ref):
        err = rel_err(g, r)
        if not err <= KERNEL_RTOL[dtype]:
            raise AssertionError(f"{label} {dtype}: rel err {err:.3e} > "
                                 f"{KERNEL_RTOL[dtype]:g}")
        results["max_abs_err"] = max(results["max_abs_err"], max_abs(g, r))
        results["max_rel_err"][dtype] = max(results["max_rel_err"][dtype], err)


def report(name, n_checks, results):
    print(f"[kernels] {name}: {n_checks} checks passed, max abs err "
          f"{results['max_abs_err']:.3e}, max rel err "
          f"{results['max_rel_err'][torch.float32]:.3e} (f32) "
          f"{results['max_rel_err'][torch.float64]:.3e} (f64)", flush=True)


def check_poisson(results):
    """Every mode, both dtypes, wall and periodic, on every multigrid
    level of the 256^2 and 1024^2 cavities."""
    rng = np.random.default_rng(0)
    n_checks = 0
    for dtype in (torch.float32, torch.float64):
        for periodic in (False, True):
            for N in (256, 1024):
                mg = mg_mod.PoissonMG(unit_mesh(N, periodic), bcs_for(periodic),
                                      scale=0.01, dtype=dtype, device="cuda")
                for lvl in mg.levels:
                    shape = lvl.mesh.cell_shape
                    p, b = (torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                            device="cuda") for _ in range(2))
                    for mode in cuda_stencil.POISSON_MODES:
                        args = {"apply": (), "residual": (b,),
                                "smooth": (b, lvl.inv_diag, 0.8)}[mode]
                        got = cuda_stencil.poisson2d(mode, p, lvl.coeffs, *args)
                        ref = cuda_stencil.poisson2d_plain(mode, p, lvl.coeffs, *args)
                        torch.cuda.synchronize()
                        check_kernel(results, f"poisson2d {mode} periodic={periodic} "
                                     f"{shape}", dtype, (got,), (ref,))
                        n_checks += 1
    report("poisson2d", n_checks, results)


def momentum_cases(dtype):
    """(name, ops, W) from real steps: the cavity after 2 steps (wall
    boundaries) and the Taylor-Green vortex (periodic)."""
    cav = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda", dtype=dtype)
    cav.impl.cfg = CNLinearConfig.production()
    cav.advance(2)
    tgv = setup_taylor_green_2d(N=256, nsteps=10, t_final=0.1, periodic=True,
                                device="cuda", dtype=dtype)
    out = []
    for name, ns in (("cavity", cav), ("tgv-periodic", tgv)):
        ops = ns.impl.ops
        v0f = step_v0f(ops, ns.state, ns.t)
        out.append((name, ops, ops.build_momentum_coeffs_stacked(ns.state["U"], v0f)))
    return out


def check_momentum(results):
    rng = np.random.default_rng(1)
    n_checks = 0
    for dtype in (torch.float32, torch.float64):
        for name, ops, W in momentum_cases(dtype):
            u, v = (torch.as_tensor(rng.standard_normal(ops.mesh.cell_shape),
                                    dtype=dtype, device="cuda") for _ in range(2))
            got = cuda_stencil.momentum2d(W, u, v, ops.mesh.periodic)
            ref = cuda_stencil.momentum2d_plain(W, u, v, ops.mesh.periodic)
            torch.cuda.synchronize()
            check_kernel(results, f"momentum2d {name}", dtype, got, ref)
            n_checks += 1
    report("momentum2d", n_checks, results)


def time_one(label, kernel, plain, nbytes, calls=50, replays=20, iters=200):
    """Device time (CUDA graph of ``calls`` launches) and eager time per
    call of a kernel and its plain version; returns the device times."""
    ms = graph_ms(kernel, calls, replays)
    plain_ms = graph_ms(plain, calls, replays)
    eager, plain_eager = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    print(f"[time] {label}: kernel {ms:.5f} ms on the device "
          f"({nbytes / ms / 1e6:.1f} GB/s of field traffic), {eager:.5f} ms "
          f"per eager call; plain {plain_ms:.5f} ms on the device, "
          f"{plain_eager:.5f} ms per eager call", flush=True)
    return ms, plain_ms


def time_kernels(poisson, momentum):
    rng = np.random.default_rng(2)
    f32 = torch.float32
    for N in (256, 4096):
        mesh = unit_mesh(N, False)
        axbcs = T_.axis_bcs(mesh, cavity_bcs())
        lvl = mg_mod._build_level(mesh, axbcs, 0.01, f32, "cuda")
        p, b = (torch.as_tensor(rng.standard_normal((N, N)), dtype=f32, device="cuda")
                for _ in range(2))
        for mode in cuda_stencil.POISSON_MODES:
            args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag, 0.8)}[mode]
            nbytes = (2 + sum(torch.is_tensor(a) for a in args)) * N * N * 4
            ms, plain_ms = time_one(
                f"poisson2d {mode} {N}^2 f32",
                lambda: cuda_stencil.poisson2d(mode, p, lvl.coeffs, *args),
                lambda: cuda_stencil.poisson2d_plain(mode, p, lvl.coeffs, *args),
                nbytes)
            if N == 256 and mode == "apply":
                poisson["ms"], poisson["plain_ms"] = ms, plain_ms
    (name, ops, W), _ = momentum_cases(f32)
    u, v = (torch.as_tensor(rng.standard_normal((256, 256)), dtype=f32, device="cuda")
            for _ in range(2))
    per = ops.mesh.periodic
    momentum["ms"], momentum["plain_ms"] = time_one(
        f"momentum2d 256^2 f32 ({name} planes)",
        lambda: cuda_stencil.momentum2d(W, u, v, per),
        lambda: cuda_stencil.momentum2d_plain(W, u, v, per),
        30 * 256 * 256 * 4)


def phase_slice(smi):
    """The 256^2 cavity, production preset: step + advance(20)."""
    ns = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
    ns.impl.cfg = CNLinearConfig.production()
    first, adv, launches = timed_run(ns, 20)
    if ns.step_index != 21 or not bool(ns.last_diag["converged"]):
        raise AssertionError(f"slice stopped at step {ns.step_index}: {ns.last_diag}")
    assert_finite(ns, "the 2-D cavity after 21 steps")
    require_launches(launches, ("poisson2d", "momentum2d"), "the 2-D cavity")
    umax = float(ns.state["v"][0].abs().max())
    if not 0.5 < umax < 1.5:
        raise AssertionError(f"|u|max {umax} out of the lid-driven range")
    print(f"[slice] cavity 256^2 Re 100 f32 production: first step "
          f"{first * 1e3:.2f} ms, advance(20) {adv * 1e3:.2f} ms = "
          f"{20 / adv:.3f} steps/s warm ({smi}); ksp_rnorm "
          f"{float(ns.last_diag['ksp_rnorm']):.4g}; |u|max {umax:.4f}; "
          f"launches {launches}", flush=True)

    # the fixed-budget step reads nothing back to the host: a
    # synchronising call inside it raises here (torch's sync debug mode
    # is a prototype and may miss some kinds of synchronisation)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ns.impl.multi_step(ns.state, ns.t, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # three more windows: the spread of the host-bound step loop
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ns.advance(20)
        torch.cuda.synchronize()
        rates.append(20 / (time.perf_counter() - t0))
    print(f"[slice] sync debug mode flagged no synchronisation inside a "
          f"production step; "
          f"steps/s over 3 more advance(20) windows: "
          f"{', '.join(f'{r:.3f}' for r in rates)}", flush=True)

    # 5 steps on the card (f32) against the plain f64 run on the CPU
    states = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        ref = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device=device, dtype=dtype)
        ref.impl.cfg = CNLinearConfig.production()
        ref.advance(5)
        states[device] = ref.state
    errs = {
        "v": max(rel_err(states["cuda"]["v"][c].cpu(), states["cpu"]["v"][c])
                 for c in range(2)),
        "p": rel_err(states["cuda"]["p"].cpu(), states["cpu"]["p"]),
    }
    for k, e in errs.items():
        if not e <= SLICE_RTOL[k]:
            raise AssertionError(f"5-step {k}: card f32 vs CPU f64 rel err "
                                 f"{e:.3e} > {SLICE_RTOL[k]:g}")
    print(f"[slice] 5 steps card f32 vs CPU f64: rel err v {errs['v']:.3e} "
          f"(bound {SLICE_RTOL['v']:g}), p {errs['p']:.3e} (bound "
          f"{SLICE_RTOL['p']:g})", flush=True)
    return launches


def phase_app():
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(["-device", "cuda", "-cart_grid_x", "256", "-cart_grid_y", "256",
                       "-ns_max_steps", "3", "-ns_monitor"])
    out = buf.getvalue()
    print(out, end="")
    if rc != 0 or "done: CONVERGED_ITS" not in out:
        raise AssertionError(f"app run did not end CONVERGED_ITS (rc {rc})")
    print(f"[app] 3 FGMRES rtol 1e-5 steps at 256^2 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# ----------------------------------------------------------------------
# 3-D
# ----------------------------------------------------------------------

def vec_rel_err(a, b) -> float:
    """||a - b|| / ||b|| over tuples of fields taken as one vector."""
    num = sum(float(torch.sum((x.double() - y.double()) ** 2)) for x, y in zip(a, b))
    den = sum(float(torch.sum(y.double() ** 2)) for y in b)
    return (num / den) ** 0.5


def runs3d(dtype):
    """The 64x64x32 cavity and the stretched 128^3 channel after 2
    production steps on the card."""
    cav = setup_cavity_3d(N=(64, 64, 32), Re=100.0, dt=0.01, device="cuda",
                          dtype=dtype)
    chan = setup_channel_3d(N=(128, 128, 128), stretch_y=2.0, dt=2e-3,
                            device="cuda", dtype=dtype)
    for ns in (cav, chan):
        ns.impl.cfg = CNLinearConfig.production()
        ns.advance(2)
    return (("cavity 64x64x32", cav), ("channel 128^3 stretched", chan))


def check_poisson3d_modes(results, label, rng, coeffs, inv_diag):
    """The three modes of the Poisson 3-D kernel against the plain
    version on one level's coefficients; returns the number of checks."""
    dtype = coeffs.a0.dtype
    p, b = (torch.as_tensor(rng.standard_normal(coeffs.shape), dtype=dtype,
                            device="cuda") for _ in range(2))
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, inv_diag, 0.8)}[mode]
        got = cuda_stencil.poisson3d(mode, p, coeffs, *args)
        ref = cuda_stencil.poisson3d_plain(mode, p, coeffs, *args)
        torch.cuda.synchronize()
        check_kernel(results, f"poisson3d {mode} {label} {coeffs.shape}", dtype,
                     (got,), (ref,))
    return len(cuda_stencil.POISSON_MODES)


def check_poisson3d(results, runs):
    """Every mode, both dtypes, on every multigrid level of the cavity
    (walls and a SYMMETRY plane) and of the stretched channel (periodic
    x and z)."""
    rng = np.random.default_rng(3)
    n_checks = 0
    for cases in runs.values():
        for name, ns in cases:
            for lvl in ns.impl.mg.levels:
                n_checks += check_poisson3d_modes(results, name, rng, lvl.coeffs,
                                                  lvl.inv_diag)
    report("poisson3d", n_checks, results)


def mixed_bc_ops(dtype):
    """Walls, a PRESSURE_OUTLET (+x) and a SYMMETRY plane (-z) on a
    non-uniform 64x48x40 grid: NSOperators with random face factors."""
    N = (64, 48, 40)
    mesh = CartMesh.create(N)
    mesh.set_coordinates(*[np.linspace(0.0, 1.0, n + 1) ** 1.2 for n in N])
    wall = zero_velocity_bc()
    out = BoundaryCondition(BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[0])
    sym = BoundaryCondition(BCType.SYMMETRY)
    ops = NSOperators(mesh, [wall, out, wall, wall, sym, wall], 1.3, 0.02, 0.01, dtype,
                      "cuda")
    rng = np.random.default_rng(4)

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

    U0 = tuple(rand(mesh.face_shape(d)) for d in range(3))
    v0f = tuple(tuple(rand(mesh.face_shape(d)) for _ in range(3)) for d in range(3))
    return ops, ops.build_momentum_factors_3d(U0, v0f)


def check_momentum3d(results, runs):
    rng = np.random.default_rng(5)
    n_checks = 0
    for dtype, cases in runs.items():
        factors = [(name, ns.impl.ops, ns.impl.ops.build_momentum_factors_3d(
            ns.state["U"], step_v0f(ns.impl.ops, ns.state, ns.t))) for name, ns in cases]
        factors.append(("mixed outlet/symmetry", *mixed_bc_ops(dtype)))
        for name, ops, f in factors:
            v = tuple(torch.as_tensor(rng.standard_normal(ops.mesh.cell_shape),
                                      dtype=dtype, device="cuda") for _ in range(3))
            got = cuda_stencil.momentum3d(ops.mom_bands3d, f, v)
            ref = cuda_stencil.momentum3d_plain(ops.mom_bands3d, f, v)
            torch.cuda.synchronize()
            check_kernel(results, f"momentum3d {name}", dtype, got, ref)
            n_checks += 1
    report("momentum3d", n_checks, results)


def check_channel512(poisson, momentum, ns):
    """The 3-D kernels against their plain versions at the shapes of the
    512x256x256 channel: the three Poisson modes on every multigrid
    level and the momentum kernel on the current step factors. float32
    as the run holds them; float64 on the same arrays widened."""
    rng = np.random.default_rng(7)
    ops = ns.impl.ops
    bands = ops.mom_bands3d
    U0, v0f = ns.state["U"], step_v0f(ops, ns.state, ns.t)
    n_poisson = n_momentum = 0
    for dtype in (torch.float32, torch.float64):
        for lvl in ns.impl.mg.levels:
            c = lvl.coeffs
            coeffs = cuda_stencil.Poisson3DCoeffs(
                *(x.to(dtype) for x in (c.a0, c.c1, c.c2, c.h0, c.h1, c.h2)),
                c.periodic)
            n_poisson += check_poisson3d_modes(poisson, "channel 512", rng, coeffs,
                                               lvl.inv_diag.to(dtype))
        bands_d = cuda_stencil.Momentum3DBands(tuple(B.to(dtype) for B in bands.b),
                                               bands.periodic)
        f = cuda_stencil.Momentum3DFactors.from_faces(U0, v0f, bands_d)
        v = tuple(torch.as_tensor(rng.standard_normal(ns.mesh.cell_shape), dtype=dtype,
                                  device="cuda") for _ in range(3))
        got = cuda_stencil.momentum3d(bands_d, f, v)
        ref = cuda_stencil.momentum3d_plain(bands_d, f, v)
        torch.cuda.synchronize()
        check_kernel(momentum, "momentum3d channel 512", dtype, got, ref)
        n_momentum += 1
        del f, v, got, ref
    report("poisson3d (with the 512x256x256 channel's levels)", n_poisson, poisson)
    report("momentum3d (with the 512x256x256 channel's factors)", n_momentum, momentum)


def time_kernels3d(label, ns, calls=50, replays=20, iters=200):
    """The 3-D kernels against their plain versions on the finest level
    and the current factors of ``ns`` (float32), ``calls`` launches per
    CUDA graph; returns the device times (kernel, plain) of the Poisson
    apply and of the momentum apply."""
    rng = np.random.default_rng(6)
    shape = ns.mesh.cell_shape
    n = int(np.prod(shape))
    reps = {"calls": calls, "replays": replays, "iters": iters}

    def rand():
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device="cuda")

    lvl = ns.impl.mg.levels[0]
    p, b = rand(), rand()
    out = {}
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag, 0.8)}[mode]
        nbytes = (2 + sum(torch.is_tensor(a) for a in args)) * n * 4
        out[mode] = time_one(
            f"poisson3d {mode} {label} f32",
            lambda: cuda_stencil.poisson3d(mode, p, lvl.coeffs, *args),
            lambda: cuda_stencil.poisson3d_plain(mode, p, lvl.coeffs, *args),
            nbytes, **reps)
    ops = ns.impl.ops
    f = ops.build_momentum_factors_3d(ns.state["U"], step_v0f(ops, ns.state, ns.t))
    v = (rand(), rand(), rand())
    mom = time_one(f"momentum3d {label} f32 (step factors)",
                   lambda: cuda_stencil.momentum3d(ops.mom_bands3d, f, v),
                   lambda: cuda_stencil.momentum3d_plain(ops.mom_bands3d, f, v),
                   18 * n * 4, **reps)
    return out["apply"], mom


def phase_slice3d(smi):
    """The 64x64x32 cavity and the 128^3 channel, production preset."""
    ns = setup_cavity_3d(N=(64, 64, 32), Re=100.0, dt=0.01, device="cuda")
    ns.impl.cfg = CNLinearConfig.production()
    first, adv, launches = timed_run(ns, 20)
    if ns.step_index != 21 or not bool(ns.last_diag["converged"]):
        raise AssertionError(f"3-D cavity stopped at step {ns.step_index}: "
                             f"{ns.last_diag}")
    assert_finite(ns, "the 3-D cavity after 21 steps")
    require_launches(launches, ("poisson3d", "momentum3d"), "the 3-D cavity")
    umax = float(ns.state["v"][0].abs().max())
    if not 0.5 < umax < 1.5:
        raise AssertionError(f"|u|max {umax} out of the lid-driven range")
    print(f"[slice3d] cavity 64x64x32 Re 100 f32 production: first step "
          f"{first * 1e3:.2f} ms, advance(20) {adv * 1e3:.2f} ms = "
          f"{20 / adv:.3f} steps/s warm ({smi}); ksp_rnorm "
          f"{float(ns.last_diag['ksp_rnorm']):.4g}; |u|max {umax:.4f}; "
          f"launches {launches}", flush=True)

    torch.cuda.set_sync_debug_mode("error")
    try:
        ns.impl.multi_step(ns.state, ns.t, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[slice3d] sync debug mode flagged no synchronisation inside a 3-D "
          "production step", flush=True)

    chan = setup_channel_3d(N=(128, 128, 128), dt=2e-3, device="cuda")
    chan.impl.cfg = CNLinearConfig.production()
    u0 = float(chan.state["v"][0].abs().mean())
    cfirst, cadv, claunches = timed_run(chan, 10)
    if chan.step_index != 11 or not bool(chan.last_diag["converged"]):
        raise AssertionError(f"channel 128^3 stopped at step {chan.step_index}")
    assert_finite(chan, "the 128^3 channel after 11 steps")
    require_launches(claunches, ("poisson3d", "momentum3d"), "the 128^3 channel")
    # bench.py's 128^3 cell has no solve-quality gate: its residual and
    # mean-flow retention are printed beside the rate, not gated
    retention = float(chan.state["v"][0].abs().mean()) / u0
    print(f"[slice3d] channel 128^3 dt 2e-3 f32 production: first step "
          f"{cfirst * 1e3:.2f} ms, advance(10) {cadv * 1e3:.2f} ms = "
          f"{10 / cadv:.3f} steps/s warm ({smi}), no solve-quality gate; "
          f"ksp_rnorm {float(chan.last_diag['ksp_rnorm']):.4g}; retention "
          f"{retention:.5f} over 11 steps; launches {claunches}", flush=True)

    states = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        ref = setup_cavity_3d(N=(64, 64, 32), Re=100.0, dt=0.01, device=device,
                              dtype=dtype)
        ref.impl.cfg = CNLinearConfig.production()
        ref.advance(5)
        states[device] = ref.state
    errs = {
        "v": vec_rel_err([x.cpu() for x in states["cuda"]["v"]], states["cpu"]["v"]),
        "p": rel_err(states["cuda"]["p"].cpu(), states["cpu"]["p"]),
    }
    for k, e in errs.items():
        if not e <= SLICE3D_RTOL[k]:
            raise AssertionError(f"3-D 5-step {k}: card f32 vs CPU f64 rel err "
                                 f"{e:.3e} > {SLICE3D_RTOL[k]:g}")
    print(f"[slice3d] 5 cavity steps card f32 vs CPU f64: rel err v "
          f"{errs['v']:.3e} (bound {SLICE3D_RTOL['v']:g}), p {errs['p']:.3e} "
          f"(bound {SLICE3D_RTOL['p']:g})", flush=True)
    return launches


def phase_channel512(smi, poisson, momentum, profile=False):
    """BASELINE config #5 at full size: 512x256x256, tanh-stretched y,
    dt 5e-5, float32, production (outer 3, BiCGStab 8, CG+MG 6). As
    bench.py's channel512 cell: retention over 1 step + advance(10),
    then the ksp_rnorm gate on the worst step of the 20-step batch that
    follows 72 steps (steps 73-92), also the timed window."""
    t0 = time.perf_counter()
    ns = setup_channel_3d(N=(512, 256, 256), dt=5e-5, stretch_y=2.0, device="cuda")
    ns.impl.cfg = CNLinearConfig.production(3, 8, 6)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    u0 = float(ns.state["v"][0].abs().mean())
    first, adv, launches = timed_run(ns, 10)
    retention = float(ns.state["v"][0].abs().mean()) / u0
    early_rnorm = float(ns.last_diag["ksp_rnorm"])
    assert_finite(ns, "the 512x256x256 channel after 11 steps")
    require_launches(launches, ("poisson3d", "momentum3d"), "the 512x256x256 channel")
    print(f"[channel512] 512x256x256 stretch_y 2.0 dt 5e-5 f32 production(3, 8, 6): "
          f"setup {setup_s:.2f} s, first step {first * 1e3:.2f} ms, advance(10) "
          f"{adv * 1e3:.2f} ms; retention {retention:.5f} (gate >= {RETENTION_MIN}); "
          f"ksp_rnorm max over steps 2-11 {early_rnorm:.4g}; launches {launches}",
          flush=True)
    if not retention >= RETENTION_MIN:
        raise AssertionError(f"channel512 mean flow decayed: retention {retention}")
    ns.advance(61)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns.advance(20)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rnorm = float(ns.last_diag["ksp_rnorm"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert_finite(ns, "the 512x256x256 channel after 92 steps")
    print(f"[channel512] steps 73-92: advance(20) {window * 1e3:.2f} ms = "
          f"{20 / window:.4f} steps/s ({smi}); ksp_rnorm max {rnorm:.4g} (gate <= "
          f"{RNORM_MAX}); peak memory {peak:.2f} GiB", flush=True)
    if not rnorm <= RNORM_MAX:
        raise AssertionError(f"channel512 ksp_rnorm {rnorm} > {RNORM_MAX}")
    check_channel512(poisson, momentum, ns)
    time_kernels3d("512x256x256", ns, calls=5, replays=4, iters=10)
    if profile:
        phase_profile("channel 512x256x256", ns)


def phase_app3d():
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(["-device", "cuda", "-cart_dim", "3", "-cart_grid_x", "64",
                       "-cart_grid_y", "64", "-cart_grid_z", "64",
                       "-ns_max_steps", "3", "-ns_monitor"])
    out = buf.getvalue()
    print(out, end="")
    if rc != 0 or "done: CONVERGED_ITS" not in out:
        raise AssertionError(f"3-D app run did not end CONVERGED_ITS (rc {rc})")
    print(f"[app3d] 3 FGMRES rtol 1e-5 steps at 64^3 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_profile(label, ns):
    """Device time by kernel over 3 warm production steps of ``ns``."""
    from torch.profiler import ProfilerActivity, profile

    ns.impl.cfg = CNLinearConfig.production()
    ns.advance(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ns.advance(3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3  # ms
    n_launch = sum(e.count for e in events)
    print(f"[profile] {label}, 3 steps: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * (1 - busy / (wall * 1e3)):.1f}% idle), {n_launch} "
          f"kernel launches", flush=True)
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown of 3 steps of "
                         "the 2-D cavity, the 3-D cavity and the 128^3 channel")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()

    def entry(name, replaces):
        return {"name": name, "route": "cuda",
                "source": f"fluca_tpu_torch/csrc/{name}.cu",
                "replaces": f"fluca_tpu/ops/pallas_stencil.py:{replaces}",
                "max_abs_err": 0.0,
                "max_rel_err": {torch.float32: 0.0, torch.float64: 0.0}}

    poisson, momentum = entry("poisson2d", 88), entry("momentum2d", 595)
    poisson3d, momentum3d = entry("poisson3d", 324), entry("momentum3d", 830)
    check_poisson(poisson)
    check_momentum(momentum)
    runs = {dtype: runs3d(dtype) for dtype in (torch.float32, torch.float64)}
    check_poisson3d(poisson3d, runs)
    check_momentum3d(momentum3d, runs)
    time_kernels(poisson, momentum)
    ((poisson3d["ms"], poisson3d["plain_ms"]),
     (momentum3d["ms"], momentum3d["plain_ms"])) = time_kernels3d(
        "128^3", runs[torch.float32][1][1])
    del runs
    launches = phase_slice(smi)
    phase_app()
    launches3d = phase_slice3d(smi)
    phase_channel512(smi, poisson3d, momentum3d, profile=args.profile)
    phase_app3d()
    if args.profile:
        phase_profile("cavity 256^2",
                      setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda"))
        phase_profile("cavity 64x64x32", setup_cavity_3d(
            N=(64, 64, 32), Re=100.0, dt=0.01, device="cuda"))
        phase_profile("channel 128^3", setup_channel_3d(
            N=(128, 128, 128), dt=2e-3, device="cuda"))
    for k in (poisson, momentum):
        k["launches"] = launches[k["name"]]
    for k in (poisson3d, momentum3d):
        k["launches"] = launches3d[k["name"]]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys}
                                  for d in (poisson, momentum, poisson3d, momentum3d)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
