"""Smoke test of fluca_tpu_torch on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase; exits non-zero on any failure
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of 3 steps

Phases:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the CUDA kernels from fluca_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card
     (float32 and float64, wall and periodic boundaries, the three Poisson
     modes on every multigrid level of the 256^2 and 1024^2 cavities, the
     momentum kernel on the coefficient planes of real cavity and
     Taylor-Green steps), and their times beside the plain versions';
  4. slice: the 256^2 Re 100 lid-driven cavity with the fixed-budget
     production solver, one step and advance(20), with the kernels' launch
     counts; then 5 steps against the plain float64 run on the CPU;
  5. app: the CLI entry point with the reference's FGMRES rtol 1e-5 solver.
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": ...}.

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
from fluca_tpu_torch.models.cavity import setup_cavity_2d
from fluca_tpu_torch.models.tgv import setup_taylor_green_2d
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
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
                        err = rel_err(got, ref)
                        if not err <= KERNEL_RTOL[dtype]:
                            raise AssertionError(
                                f"poisson2d {mode} {dtype} periodic={periodic} "
                                f"{shape}: rel err {err:.3e} > {KERNEL_RTOL[dtype]:g}")
                        results["max_abs_err"] = max(results["max_abs_err"],
                                                     max_abs(got, ref))
                        n_checks += 1
    print(f"[kernels] poisson2d: {n_checks} checks passed, max abs err "
          f"{results['max_abs_err']:.3e}", flush=True)


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
        U0 = ns.state["U"]
        Bv0 = ops.apply_B(ns.state["v"])
        bcB = ops.bc_B(ns.t)
        v0f = tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(2)) for d in range(2))
        out.append((name, ops, ops.build_momentum_coeffs_stacked(U0, v0f)))
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
            for c in range(2):
                err = rel_err(got[c], ref[c])
                if not err <= KERNEL_RTOL[dtype]:
                    raise AssertionError(f"momentum2d {name} {dtype} component {c}: "
                                         f"rel err {err:.3e} > {KERNEL_RTOL[dtype]:g}")
                results["max_abs_err"] = max(results["max_abs_err"],
                                             max_abs(got[c], ref[c]))
            n_checks += 1
    print(f"[kernels] momentum2d: {n_checks} checks passed, max abs err "
          f"{results['max_abs_err']:.3e}", flush=True)


def time_one(label, kernel, plain, nbytes):
    """Device time (CUDA graph) and eager time per call of a kernel and
    its plain version; returns the device times."""
    ms, plain_ms = graph_ms(kernel), graph_ms(plain)
    eager, plain_eager = cuda_ms(kernel), cuda_ms(plain)
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
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    ns.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ns.advance(20)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k.name: k.launches for k in cuda_stencil.KERNELS}
    if ns.step_index != 21 or not bool(ns.last_diag["converged"]):
        raise AssertionError(f"slice stopped at step {ns.step_index}: {ns.last_diag}")
    for name, leaf in (("v0", ns.state["v"][0]), ("v1", ns.state["v"][1]),
                       ("U0", ns.state["U"][0]), ("U1", ns.state["U"][1]),
                       ("p", ns.state["p"]), ("phalf", ns.state["phalf"])):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"non-finite {name} after 21 steps")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the slice")
    umax = float(ns.state["v"][0].abs().max())
    if not 0.5 < umax < 1.5:
        raise AssertionError(f"|u|max {umax} out of the lid-driven range")
    print(f"[slice] cavity 256^2 Re 100 f32 production: first step "
          f"{(t1 - t0) * 1e3:.2f} ms, advance(20) {(t2 - t1) * 1e3:.2f} ms = "
          f"{20 / (t2 - t1):.3f} steps/s warm ({smi}); ksp_rnorm "
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


def phase_profile():
    """Device time by kernel over 3 warm production steps."""
    from torch.profiler import ProfilerActivity, profile

    ns = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
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
    print(f"[profile] 3 steps: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * (1 - busy / (wall * 1e3)):.1f}% idle), {n_launch} kernel launches",
          flush=True)
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown of 3 steps")
    args = ap.parse_args(argv)

    smi = phase_device()
    phase_build()
    poisson = {"name": "poisson2d", "route": "cuda",
               "source": "fluca_tpu_torch/csrc/poisson2d.cu",
               "replaces": "fluca_tpu/ops/pallas_stencil.py:88", "max_abs_err": 0.0}
    momentum = {"name": "momentum2d", "route": "cuda",
                "source": "fluca_tpu_torch/csrc/momentum2d.cu",
                "replaces": "fluca_tpu/ops/pallas_stencil.py:595", "max_abs_err": 0.0}
    check_poisson(poisson)
    check_momentum(momentum)
    time_kernels(poisson, momentum)
    launches = phase_slice(smi)
    phase_app()
    if args.profile:
        phase_profile()
    for k in (poisson, momentum):
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (poisson, momentum)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
