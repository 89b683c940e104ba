"""Smoke test of fluca_tpu_torch on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase; exits non-zero on any failure
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of 3 steps
                                     # of the 2-D cavity, 3-D cavity and the
                                     # channels, float32 and bf16

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
     SYMMETRY boundaries; and each kernel's bf16 instance against its bf16
     plain version: the Poisson modes on every level of the 256^2 cavity's
     bf16 hierarchy, the 2-D momentum kernel on real cavity and Taylor-Green
     planes cast to bf16 (the 3-D bf16 checks run in phases 7 and 8);
  4. time: device time (CUDA graph) and eager time of each kernel and its
     plain version, with its bound, float32 and bf16: 2-D at 256^2 and
     4096^2, 3-D at 128^3;
  5. slice 2-D: the 256^2 Re 100 lid-driven cavity with the fixed-budget
     production solver, one step and advance(20), with the 2-D kernels'
     launch counts; then 5 steps against the plain float64 run on the CPU;
     the same with the bf16 preconditioner on both inner solves; and
     fluca_tpu's own accuracy pin of the bf16 preconditioner (the 128^2
     cavity, 50 steps, against the converged solve); and the two bf16
     inner solves of its preconditioner against the exact solution;
  6. app 2-D: the CLI entry point with the reference's FGMRES rtol 1e-5
     solver;
  7. slice 3-D: the 64x64x32 cavity (SYMMETRY back plane), step and
     advance(20), with the 3-D kernels' launch counts, and the 128^3
     channel (its residual and mean-flow retention printed, not gated,
     as bench.py does), production, in float32 and with the bf16
     preconditioner on both inner solves (bench.py:385-392); the 3-D bf16
     instances against their plain versions on the bf16 run's multigrid
     levels and step factors; 5 cavity steps against the plain float64
     run on the CPU;
  8. channel 512: the wall-clustered 512x256x256 channel (BASELINE config
     #5) at full size, 92 steps, gated as bench.py gates it: finite fields,
     mean-flow retention >= 0.9 after 11 steps, ksp_rnorm <= 500 over
     steps 73-92 (steps/s over those 20); then the 3-D kernels against
     their plain versions at its shapes (the Poisson modes on every
     multigrid level, the momentum kernel on the step's factors; float32
     and float64) and their times at 512x256x256. First in float32 with
     production(3, 8, 6); then with the solver fluca_tpu ships for this
     channel (bench.py:450-454: production(2, 6, 8), Jacobi momentum, the
     bf16 preconditioner on the momentum solve), under the same gates, with
     the bf16 instances checked and timed at its shapes;
  9. app 3-D: the CLI entry point at 64^3 with -cart_dim 3.
It prints the kernels' JSON summary, then the card's name and power limit
as nvidia-smi gives them, and last {"ok": true, "device": ...}.

Imports nothing of JAX: the card's machine has none.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
# A bf16 instance against its bf16 plain version: both sum in float32
# and round once, at the store, so they differ only on the elements where
# the two float32 results (~1e-7 apart) straddle a bf16 rounding point, by
# one bf16 unit there (at most 2^-7 of the value): a norm-relative error
# of 1e-5 to 1e-4 (up to 8.7e-5 on the H100). The bound is bf16's unit
# roundoff, 2^-8 = 3.9e-3; a wrong
# coefficient, offset or a float32 plane read as bf16 gives O(1e-2) or more.
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13, torch.bfloat16: 4e-3}
BF16 = torch.bfloat16
DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64", BF16: "bf16"}
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
# 5 fixed-budget 256^2 cavity steps with the bf16 preconditioner (float32
# solver, card) vs the plain float64 run without it (CPU), as SLICE_RTOL.
# On the momentum solve alone it gives 3.6e-2 (v) and 4.0e-2 (p) on the
# CPU, 4.1e-2 and 2.9e-2 on the card; the bounds leave a factor of 5. On
# both inner solves the comparison is printed and is no check: the
# impulsive start at CFL 2.56 is not resolved by the production budget in
# any precision (step 1 ends at ksp_rnorm 26 in float64), and with bf16 on
# both inner solves the startup swing does not die out (phase_slice_bf16),
# in fluca_tpu's own code too (tests/test_torch_bf16_witness.py): 0.82 and
# 0.10 on the CPU, 0.50 and 0.46 on the card. The bf16 accuracy gates are
# BUDGET_MAX_DEV and INNER_BF16_MAX.
SLICE_BF16_RTOL = {"v": 0.2, "p": 0.2}
# The two bf16 inner solves on the card, against the exact float64
# solution on the CPU, as ||x - exact|| / ||exact||, on the inputs of
# tests/test_torch_bf16_witness.py (the 128^2 cavity at dt 0.005): the
# Schur solve (6 CG iterations over the bf16 multigrid, with the
# projection) on a random and a smooth rhs, and the momentum solve (8
# BiCGStab iterations) at a random state. fluca_tpu's own bf16 solves, run
# op by op on the CPU, give 1.0e-2, 1.9e-2 and 6.9e-3 there, the port's
# 5.3e-3, 2.9e-3 and 5.3e-3; the bounds are 1.5x fluca_tpu's readings, as
# that test holds the port on the CPU. A wrong coefficient, projection or
# coarse solve gives O(1e-1) or more.
INNER_BF16_MAX = {"schur random": 1.5e-2, "schur smooth": 2.8e-2, "momentum": 1.0e-2}
# fluca_tpu's accuracy pin of the bf16 preconditioner
# (examples/tune_budget_tpu.py): the 128^2 cavity, dt 0.005, 50 float32
# steps, max |deviation| over u, v and p from the converged FGMRES rtol
# 1e-5 solve. float32 production is held to the repo's production pin,
# 2e-4 U_lid (tests/test_fastpath.py); the bf16 preconditioner (both) to
# 5e-2 U_lid. fluca_tpu measured 1.31e-4 and 9.36e-3 on its TPU
# (TUNE_BUDGET_TPU.json), where XLA fuses several operations into one
# rounding; its own code run op by op on the CPU gives 2.03e-2, the port
# 1.5e-2 to 2.3e-2 on the CPU (by thread count) and 2.96e-2 on the H100
# (tests/test_torch_bf16_witness.py pin).
BUDGET_MAX_DEV = {"f32": 2e-4, "bf16": 5e-2}
# The BASELINE #5 channel's solve-quality gates (bench.py:52-53, 474-480).
RETENTION_MIN = 0.9
RNORM_MAX = 500.0
# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# H100 SXM's 3.35 TB/s and its float32 operations over its 67 TFLOP/s
# outside the tensor cores (NVIDIA's data sheet). The bf16 instances
# compute in float32 too.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations per cell, counted from the kernels' source: Poisson
# 2-D (6 + 6 + 1 for Sp, then b - Sp and p + omega w (b - Sp)), Poisson
# 3-D (15 for the three axis sums, 7 to combine them), momentum 2-D (13
# products and 12 sums per component), momentum 3-D (per axis 10 for the
# normal sums, 11 for c == a and 24 for each c != a; the +-2 boundary rows
# are left out: they act on the boundary cells only)
FLOPS_PER_CELL = {
    "poisson2d": {"apply": 13, "residual": 14, "smooth": 17},
    "poisson3d": {"apply": 22, "residual": 23, "smooth": 26},
    "momentum2d": 50,
    "momentum3d": 207,
}


def nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def coeff_tensors(c):
    """The arrays of a Poisson coefficient set."""
    return [getattr(c, k) for k in ("rx", "ry", "cy", "cyb", "a0", "c1", "c2",
                                    "h0", "h1", "h2") if hasattr(c, k)]


def bound(nbytes_moved, flops):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def launch_counts():
    """Launches since the last reset, by instance: "poisson2d" for the
    float32 one, "poisson2d_bf16" for the bf16 one, and so on."""
    out = {}
    for k in cuda_stencil.KERNELS:
        out[k.name] = k.launches_by_dtype["f32"]
        out[f"{k.name}_bf16"] = k.launches_by_dtype["bf16"]
    return out


def timed_run(ns, n):
    """One step, then advance(n), between synchronisations; returns
    (first-step s, advance s, launches by instance)."""
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    ns.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ns.advance(n)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, launch_counts()


def require_launches(launches, names, what):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by {what}")


def per_step(launches, steps):
    """The launched instances' counts per step."""
    return {k: round(v / steps, 2) for k, v in launches.items() if v}


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
    errs = " ".join(f"{e:.3e} ({DTYPE_NAMES[d]})"
                    for d, e in results["max_rel_err"].items())
    print(f"[kernels] {name}: {n_checks} checks passed, max abs err "
          f"{results['max_abs_err']:.3e}, max rel err {errs}", flush=True)


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


def check_poisson_bf16(results):
    """Every mode of the bf16 instance on every level of the 256^2
    cavity's bf16 hierarchy (bf16 fields, float32 coefficients)."""
    rng = np.random.default_rng(10)
    mg = mg_mod.PoissonMG(unit_mesh(256, False), cavity_bcs(), scale=0.01,
                          dtype=BF16, device="cuda")
    n_checks = sum(check_poisson_modes(results, "cavity 256^2", rng, lvl.coeffs,
                                       lvl.inv_diag) for lvl in mg.levels)
    report("poisson2d_bf16", n_checks, results)


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


def check_momentum_bf16(results):
    """The bf16 instance on the planes of real float32 cavity and
    Taylor-Green steps cast to bf16, as the step casts them."""
    rng = np.random.default_rng(11)
    n_checks = 0
    for name, ops, W in momentum_cases(torch.float32):
        u, v = (torch.as_tensor(rng.standard_normal(ops.mesh.cell_shape), dtype=BF16,
                                device="cuda") for _ in range(2))
        W16 = W.to(BF16)
        got = cuda_stencil.momentum2d(W16, u, v, ops.mesh.periodic)
        ref = cuda_stencil.momentum2d_plain(W16, u, v, ops.mesh.periodic)
        torch.cuda.synchronize()
        check_kernel(results, f"momentum2d {name}", BF16, got, ref)
        n_checks += 1
    report("momentum2d_bf16", n_checks, results)


def time_one(label, kernel, plain, nbytes_moved, flops, calls=50, replays=20,
             iters=200):
    """Device time (CUDA graph of ``calls`` launches) and eager time per
    call of a kernel and its plain version, beside the bound of the
    kernel's work; returns the device times and the bound."""
    ms = graph_ms(kernel, calls, replays)
    plain_ms = graph_ms(plain, calls, replays)
    eager, plain_eager = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    bound_ms, bound_by = bound(nbytes_moved, flops)
    print(f"[time] {label}: kernel {ms:.5f} ms on the device "
          f"({nbytes_moved / ms / 1e6:.1f} GB/s moved; bound {bound_ms:.5f} ms by "
          f"{bound_by}, {100 * bound_ms / ms:.1f} % of the kernel's time), "
          f"{eager:.5f} ms per eager call; plain {plain_ms:.5f} ms on the "
          f"device, {plain_eager:.5f} ms per eager call", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def time_kernels(entries):
    """The 2-D kernels, float32 and bf16: Poisson at 256^2 and 4096^2,
    momentum on real cavity planes at 256^2 and random planes at 4096^2.
    The 256^2 apply and momentum times go to ``entries``."""
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    (name, ops, W), _ = momentum_cases(torch.float32)
    per = ops.mesh.periodic
    for dtype in (torch.float32, BF16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        dname = DTYPE_NAMES[dtype]
        for N in (256, 4096):
            mesh = unit_mesh(N, False)
            axbcs = T_.axis_bcs(mesh, cavity_bcs())
            lvl = mg_mod._build_level(mesh, axbcs, 0.01, dtype, "cuda")
            p, b = (torch.as_tensor(rng.standard_normal(mesh.cell_shape), dtype=dtype,
                                    device="cuda") for _ in range(2))
            for mode in cuda_stencil.POISSON_MODES:
                args = {"apply": (), "residual": (b,),
                        "smooth": (b, lvl.inv_diag, 0.8)}[mode]
                t = time_one(
                    f"poisson2d {mode} {N}^2 {dname}",
                    lambda: cuda_stencil.poisson2d(mode, p, lvl.coeffs, *args),
                    lambda: cuda_stencil.poisson2d_plain(mode, p, lvl.coeffs, *args),
                    nbytes(p, p, *args, *coeff_tensors(lvl.coeffs)),
                    N * N * FLOPS_PER_CELL["poisson2d"][mode])
                if N == 256 and mode == "apply":
                    entries["poisson2d" + sfx].update(t)
        for N, planes, reps in ((256, W.to(dtype), {}),
                                (4096, None, {"calls": 5, "replays": 4, "iters": 10})):
            kind = "random" if planes is None else name
            if planes is None:
                planes = torch.randn((26, N, N), generator=gen, device="cuda").to(dtype)
            u, v = (torch.as_tensor(rng.standard_normal(planes.shape[1:]),
                                    dtype=dtype, device="cuda") for _ in range(2))
            t = time_one(
                f"momentum2d {N}^2 {dname} ({kind} planes)",
                lambda: cuda_stencil.momentum2d(planes, u, v, per),
                lambda: cuda_stencil.momentum2d_plain(planes, u, v, per),
                nbytes(planes, u, v, u, v), N * N * FLOPS_PER_CELL["momentum2d"],
                **reps)
            if N == 256:
                entries["momentum2d" + sfx].update(t)
            del planes


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
    return launches, states["cpu"]


def bf16_precond(cfg, scope="both"):
    """``cfg`` with the bf16 ABF preconditioner on ``scope``."""
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = scope
    return cfg


def phase_slice_bf16(smi, cpu_state):
    """The 256^2 cavity, production(3, 8, 6) with the bf16 preconditioner
    on both inner solves (the reference's skipped
    tests/test_bf16_precond.py:93-103 case, at full size): step +
    advance(20); then 5 steps against the plain float64 run on the CPU
    without it (``cpu_state``), with bf16 on both inner solves (printed,
    no check) and on the momentum solve alone (SLICE_BF16_RTOL). At this
    CFL (2.56) the production budget leaves the steps unresolved in any
    precision, and with bf16 on both inner solves |u|max swings between
    ~0.01 and ~1.5 from step to step over the first 22 steps, in
    fluca_tpu's own code run op by op on the CPU too
    (tests/test_torch_bf16_witness.py cavity256): the run is held to
    finite fields and its kernels, and its |u|max at steps 21 and 22 is
    printed, not gated."""
    ns = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
    ns.impl.cfg = bf16_precond(CNLinearConfig.production(3, 8, 6))
    first, adv, launches = timed_run(ns, 20)
    if ns.step_index != 21 or not bool(ns.last_diag["converged"]):
        raise AssertionError(f"bf16 slice stopped at step {ns.step_index}: "
                             f"{ns.last_diag}")
    assert_finite(ns, "the bf16-preconditioned 2-D cavity after 21 steps")
    require_launches(launches, ("poisson2d_bf16", "momentum2d_bf16"),
                     "the bf16-preconditioned 2-D cavity")
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = ns.impl.multi_step(ns.state, ns.t, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    umax = [float(x["v"][0].abs().max()) for x in (ns.state, st)]
    print(f"[slice-bf16] cavity 256^2 Re 100 f32 production(3, 8, 6), bf16 "
          f"preconditioner (both): first step {first * 1e3:.2f} ms, advance(20) "
          f"{adv * 1e3:.2f} ms = {20 / adv:.3f} steps/s warm ({smi}); ksp_rnorm "
          f"{float(ns.last_diag['ksp_rnorm']):.4g}; |u|max at steps 21 and 22 "
          f"{umax[0]:.4f}, {umax[1]:.4f} (not gated); launches {launches}; per "
          f"step {per_step(launches, 21)}", flush=True)
    print("[slice-bf16] sync debug mode flagged no synchronisation inside a "
          "bf16-preconditioned step", flush=True)

    for scope in ("both", "mom"):
        ref = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
        ref.impl.cfg = bf16_precond(CNLinearConfig.production(3, 8, 6), scope)
        ref.advance(5)
        errs = {
            "v": max(rel_err(ref.state["v"][c].cpu(), cpu_state["v"][c])
                     for c in range(2)),
            "p": rel_err(ref.state["p"].cpu(), cpu_state["p"]),
        }
        if scope == "both":
            assert_finite(ref, "the bf16-preconditioned 2-D cavity after 5 steps")
            print(f"[slice-bf16] 5 steps card (bf16 preconditioner, both) vs CPU f64 "
                  f"production: rel err v {errs['v']:.3e}, p {errs['p']:.3e} (no "
                  f"check: the startup swing, see SLICE_BF16_RTOL)", flush=True)
            continue
        for k, e in errs.items():
            if not e <= SLICE_BF16_RTOL[k]:
                raise AssertionError(f"bf16 ({scope}) 5-step {k}: card vs CPU f64 "
                                     f"rel err {e:.3e} > {SLICE_BF16_RTOL[k]:g}")
        print(f"[slice-bf16] 5 steps card (bf16 preconditioner, {scope}) vs CPU "
              f"f64 production: rel err v {errs['v']:.3e} (bound "
              f"{SLICE_BF16_RTOL['v']:g}), p {errs['p']:.3e} (bound "
              f"{SLICE_BF16_RTOL['p']:g})", flush=True)
    return launches


def witness_inputs(mesh):
    """The inputs of tests/test_torch_bf16_witness.py, made from the same
    seeds: the Schur rhs (random and smooth, zero mean), and U0, v0f and
    the rhs of the momentum solve."""
    N = mesh.N[0]
    random = np.random.default_rng(0).standard_normal((N, N))
    x = np.linspace(0.0, 1.0, N)
    smooth = (np.sin(3 * np.pi * x)[:, None] * np.cos(2 * np.pi * x)[None, :]
              + 0.01 * np.random.default_rng(0).standard_normal((N, N)))
    rng = np.random.default_rng(1)
    U0 = tuple(0.5 * rng.standard_normal(mesh.face_shape(d)) for d in range(2))
    v0f = tuple(tuple(0.5 * rng.standard_normal(mesh.face_shape(d)) for _ in range(2))
                for d in range(2))
    rhs = tuple(rng.standard_normal(mesh.cell_shape) for _ in range(2))
    return ({"random": random - random.mean(), "smooth": smooth - smooth.mean()},
            (U0, v0f, rhs))


def phase_inner_bf16():
    """The two bf16 inner solves of the 128^2 cavity's preconditioner on
    the card, against the exact float64 solution on the CPU: see
    INNER_BF16_MAX."""
    def solver(device, dtype, cfg):
        impl = setup_cavity_2d(N=128, Re=100.0, dt=0.005, device=device,
                               dtype=dtype).impl
        impl.cfg = cfg
        return impl

    card = solver("cuda", torch.float32,
                  bf16_precond(CNLinearConfig.production(3, 8, 6)))
    exact = solver("cpu", torch.float64, CNLinearConfig(
        schur_rtol=1e-13, schur_maxiter=2000, mom_rtol=1e-13, mom_maxiter=2000))
    schur_rhs, (U0, v0f, rhs) = witness_inputs(card.mesh)
    errs = {}
    for kind, b in schur_rhs.items():
        want = exact._solve_schur(torch.tensor(b))
        got = card._solve_schur(torch.tensor(b, device="cuda").to(BF16),
                                mg=card._pre_resources()["mg"])
        if got.dtype != BF16:
            raise AssertionError(f"the bf16 Schur solve returned {got.dtype}")
        errs[f"schur {kind}"] = rel_err(got.cpu().double(), want)

    def t(xs, dtype, device):
        return tuple(torch.tensor(x, dtype=dtype, device=device) for x in xs)

    U64, v64 = t(U0, torch.float64, "cpu"), tuple(t(r, torch.float64, "cpu") for r in v0f)
    want = exact._solve_momentum(t(rhs, torch.float64, "cpu"),
                                 exact.ops.build_momentum_operator(U64, v64),
                                 exact.ops.diag_A(U64, v64))
    U32 = t(U0, torch.float32, "cuda")
    v32 = tuple(t(r, torch.float32, "cuda") for r in v0f)
    ctx = card._precond_ctx(card.ops.build_momentum_operator(U32, v32),
                            card.ops.diag_A(U32, v32), U32, v32)
    got = card._solve_momentum(t(rhs, BF16, "cuda"), ctx["Acoeffs"], ctx["diagA"])
    errs["momentum"] = vec_rel_err([x.cpu().double() for x in got], want)
    for k, e in errs.items():
        print(f"[inner-bf16] cavity 128^2 bf16 {k} solve on the card vs the exact "
              f"f64 solution: rel err {e:.4e} (gate <= {INNER_BF16_MAX[k]:g})",
              flush=True)
        if not e <= INNER_BF16_MAX[k]:
            raise AssertionError(f"bf16 {k} solve: rel err {e:.4e} > "
                                 f"{INNER_BF16_MAX[k]:g}")


def phase_budget_bf16():
    """fluca_tpu's accuracy pin of the bf16 preconditioner
    (examples/tune_budget_tpu.py) on the card: see BUDGET_MAX_DEV."""
    def run(cfg):
        ns = setup_cavity_2d(N=128, Re=100.0, dt=0.005, device="cuda")
        ns.impl.cfg = cfg
        ns.advance(50)
        return [*ns.state["v"], ns.state["p"]]

    t0 = time.perf_counter()
    ref = run(CNLinearConfig())
    for label, cfg in (("f32", CNLinearConfig.production(3, 8, 6)),
                       ("bf16", bf16_precond(CNLinearConfig.production(3, 8, 6)))):
        dev = max(max_abs(a, b) for a, b in zip(run(cfg), ref))
        print(f"[budget-bf16] cavity 128^2 dt 0.005, 50 steps, production(3, 8, "
              f"6) {label} preconditioner: max |dev| from the converged FGMRES "
              f"rtol 1e-5 solve {dev:.4e} U_lid (gate <= {BUDGET_MAX_DEV[label]:g})",
              flush=True)
        if not dev <= BUDGET_MAX_DEV[label]:
            raise AssertionError(f"budget pin ({label}): max dev {dev:.4e} > "
                                 f"{BUDGET_MAX_DEV[label]:g}")
    print(f"[budget-bf16] done in {time.perf_counter() - t0:.2f} s", flush=True)


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


def check_poisson_modes(results, label, rng, coeffs, inv_diag):
    """The three modes of the Poisson kernel of the coefficients'
    dimension against its plain version on one level's coefficients,
    with fields in ``inv_diag``'s dtype; returns the number of checks."""
    if len(coeffs.shape) == 2:
        kernel, plain = cuda_stencil.poisson2d, cuda_stencil.poisson2d_plain
    else:
        kernel, plain = cuda_stencil.poisson3d, cuda_stencil.poisson3d_plain
    dtype = inv_diag.dtype
    p, b = (torch.as_tensor(rng.standard_normal(coeffs.shape), dtype=dtype,
                            device="cuda") for _ in range(2))
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, inv_diag, 0.8)}[mode]
        got = kernel(mode, p, coeffs, *args)
        ref = plain(mode, p, coeffs, *args)
        torch.cuda.synchronize()
        check_kernel(results, f"{kernel.name} {mode} {label} {coeffs.shape}", dtype,
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
                n_checks += check_poisson_modes(results, name, rng, lvl.coeffs,
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
            n_poisson += check_poisson_modes(poisson, "channel 512", rng, coeffs,
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


def check_bf16_3d(poisson, momentum, label, ns, mg16):
    """The 3-D bf16 instances at the shapes of ``ns``: the Poisson modes
    on every level of the bf16 hierarchy ``mg16``, the momentum kernel on
    the current step's factors built in bf16 from U0 and v0f, as the
    preconditioner builds them."""
    rng = np.random.default_rng(12)
    n_poisson = sum(check_poisson_modes(poisson, label, rng, lvl.coeffs, lvl.inv_diag)
                    for lvl in mg16.levels)
    ops = ns.impl.ops
    bands = ops.momentum_bands_3d(BF16)
    f = ops.build_momentum_factors_3d(ns.state["U"], step_v0f(ops, ns.state, ns.t),
                                      BF16)
    v = tuple(torch.as_tensor(rng.standard_normal(ns.mesh.cell_shape), dtype=BF16,
                              device="cuda") for _ in range(3))
    got = cuda_stencil.momentum3d(bands, f, v)
    ref = cuda_stencil.momentum3d_plain(bands, f, v)
    torch.cuda.synchronize()
    check_kernel(momentum, f"momentum3d {label}", BF16, got, ref)
    report(f"poisson3d_bf16 (with the {label} bf16 levels)", n_poisson, poisson)
    report(f"momentum3d_bf16 (with the {label} step factors)", 1, momentum)


def time_kernels3d(label, ns, dtype, calls=50, replays=20, iters=200):
    """The 3-D kernels' ``dtype`` instances against their plain versions
    on the finest level and the current step factors of ``ns``, ``calls``
    launches per CUDA graph; returns the times of the three Poisson modes
    and of the momentum apply."""
    rng = np.random.default_rng(6)
    shape = ns.mesh.cell_shape
    n = int(np.prod(shape))
    reps = {"calls": calls, "replays": replays, "iters": iters}
    dname = DTYPE_NAMES[dtype]

    def rand():
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

    impl, ops = ns.impl, ns.impl.ops
    if dtype == impl.dtype:
        lvl = impl.mg.levels[0]
    else:
        lvl = mg_mod._build_level(ns.mesh, T_.axis_bcs(ns.mesh, ns.bcs),
                                  impl.dt / impl.rho, dtype, "cuda")
    p, b = rand(), rand()
    out = {}
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag, 0.8)}[mode]
        out[mode] = time_one(
            f"poisson3d {mode} {label} {dname}",
            lambda: cuda_stencil.poisson3d(mode, p, lvl.coeffs, *args),
            lambda: cuda_stencil.poisson3d_plain(mode, p, lvl.coeffs, *args),
            nbytes(p, p, *args, *coeff_tensors(lvl.coeffs)),
            n * FLOPS_PER_CELL["poisson3d"][mode], **reps)
    del p, b, lvl
    bands = ops.momentum_bands_3d(dtype)
    f = ops.build_momentum_factors_3d(ns.state["U"], step_v0f(ops, ns.state, ns.t),
                                      dtype)
    v = (rand(), rand(), rand())
    out["momentum"] = time_one(
        f"momentum3d {label} {dname} (step factors)",
        lambda: cuda_stencil.momentum3d(bands, f, v),
        lambda: cuda_stencil.momentum3d_plain(bands, f, v),
        nbytes(*bands.b, *v, *f.U0, *sum(f.v0f, ()), *v),
        n * FLOPS_PER_CELL["momentum3d"], **reps)
    return out


def phase_slice3d(smi, entries):
    """The 64x64x32 cavity and the 128^3 channel, production preset;
    the channel also with the bf16 preconditioner on both inner solves,
    and the 3-D bf16 instances checked on its hierarchy and factors.
    Returns the launches of the channel's float32 and bf16 runs."""
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
          f"{retention:.5f} over 11 steps; launches {claunches}; per step "
          f"{per_step(claunches, 11)}", flush=True)
    del chan

    # bench.py:385-392: the same channel with the bf16 preconditioner on
    # both inner solves
    chan = setup_channel_3d(N=(128, 128, 128), dt=2e-3, device="cuda")
    chan.impl.cfg = bf16_precond(CNLinearConfig.production())
    u0 = float(chan.state["v"][0].abs().mean())
    bfirst, badv, launches_bf16 = timed_run(chan, 10)
    if chan.step_index != 11 or not bool(chan.last_diag["converged"]):
        raise AssertionError(f"bf16 channel 128^3 stopped at step {chan.step_index}")
    assert_finite(chan, "the bf16-preconditioned 128^3 channel after 11 steps")
    require_launches(launches_bf16, ("poisson3d_bf16", "momentum3d_bf16"),
                     "the bf16-preconditioned 128^3 channel")
    retention = float(chan.state["v"][0].abs().mean()) / u0
    print(f"[slice3d-bf16] channel 128^3 dt 2e-3 f32 production, bf16 "
          f"preconditioner (both): first step {bfirst * 1e3:.2f} ms, advance(10) "
          f"{badv * 1e3:.2f} ms = {10 / badv:.3f} steps/s warm ({smi}), no "
          f"solve-quality gate; ksp_rnorm {float(chan.last_diag['ksp_rnorm']):.4g}; "
          f"retention {retention:.5f} over 11 steps; launches {launches_bf16}; per "
          f"step {per_step(launches_bf16, 11)}", flush=True)
    check_bf16_3d(entries["poisson3d_bf16"], entries["momentum3d_bf16"],
                  "channel 128^3", chan, chan.impl._pre16["mg"])
    del chan

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
    return claunches, launches_bf16


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
          f"ksp_rnorm max over steps 2-11 {early_rnorm:.4g}; launches {launches}; "
          f"per step {per_step(launches, 11)}", flush=True)
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
    time_kernels3d("512x256x256", ns, torch.float32, calls=5, replays=4, iters=10)
    if profile:
        phase_profile("channel 512x256x256", ns)


def phase_channel512_bf16(smi, poisson, momentum, profile=False):
    """BASELINE config #5 with the solver fluca_tpu ships for it
    (bench.py:450-454, its first attempt and the one that passed the
    round-5 gates): production(2, 6, 8) with Jacobi momentum and the bf16
    preconditioner on the momentum solve (scope "mom"), float32 outer.
    Only that combination runs: bench.py falls through four attempts on a
    failure, which here would hide a bf16 fault. The same gates and
    windows as phase_channel512; then the 3-D bf16 instances against
    their plain versions at its shapes (the Poisson modes on every level
    of a bf16 hierarchy for its grid, the momentum kernel on its step's
    factors built in bf16) and their times at 512x256x256."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ns = setup_channel_3d(N=(512, 256, 256), dt=5e-5, stretch_y=2.0, device="cuda")
    cfg = CNLinearConfig.production(2, 6, 8)
    cfg.mom_solver = "jacobi"
    ns.impl.cfg = bf16_precond(cfg, "mom")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    u0 = float(ns.state["v"][0].abs().mean())
    first, adv, launches = timed_run(ns, 10)
    retention = float(ns.state["v"][0].abs().mean()) / u0
    early_rnorm = float(ns.last_diag["ksp_rnorm"])
    assert_finite(ns, "the bf16-momentum 512x256x256 channel after 11 steps")
    require_launches(launches, ("momentum3d_bf16", "poisson3d"),
                     "the bf16-momentum 512x256x256 channel")
    print(f"[channel512-bf16] 512x256x256 stretch_y 2.0 dt 5e-5 f32 production(2, 6, "
          f"8), Jacobi momentum, bf16 preconditioner (mom): setup {setup_s:.2f} s, "
          f"first step {first * 1e3:.2f} ms, advance(10) {adv * 1e3:.2f} ms; "
          f"retention {retention:.5f} (gate >= {RETENTION_MIN}); ksp_rnorm max over "
          f"steps 2-11 {early_rnorm:.4g}; launches {launches}; per step "
          f"{per_step(launches, 11)}", flush=True)
    if not retention >= RETENTION_MIN:
        raise AssertionError(f"bf16 channel512 mean flow decayed: retention {retention}")
    ns.advance(61)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns.advance(20)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rnorm = float(ns.last_diag["ksp_rnorm"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert_finite(ns, "the bf16-momentum 512x256x256 channel after 92 steps")
    print(f"[channel512-bf16] steps 73-92: advance(20) {window * 1e3:.2f} ms = "
          f"{20 / window:.4f} steps/s ({smi}); ksp_rnorm max {rnorm:.4g} (gate <= "
          f"{RNORM_MAX}); peak memory {peak:.2f} GiB", flush=True)
    if not rnorm <= RNORM_MAX:
        raise AssertionError(f"bf16 channel512 ksp_rnorm {rnorm} > {RNORM_MAX}")
    mg16 = mg_mod.PoissonMG(ns.mesh, ns.bcs, scale=ns.impl.dt / ns.impl.rho,
                            dtype=BF16, device="cuda")
    check_bf16_3d(poisson, momentum, "channel 512", ns, mg16)
    del mg16
    time_kernels3d("512x256x256", ns, BF16, calls=5, replays=4, iters=10)
    if profile:
        phase_profile("channel 512x256x256 bf16-momentum", ns, ns.impl.cfg)


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


def phase_profile(label, ns, cfg=None):
    """Device time by kernel over 3 warm steps of ``ns`` under ``cfg``
    (the production preset if None)."""
    from torch.profiler import ProfilerActivity, profile

    ns.impl.cfg = cfg or CNLinearConfig.production()
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
                         "the 2-D cavity, the 3-D cavity, the 128^3 channel "
                         "(float32 and bf16) and both 512x256x256 channel runs")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()

    def entry(kernel, replaces, dtypes):
        return {"name": kernel + ("_bf16" if dtypes == (BF16,) else ""),
                "route": "cuda",
                "source": f"fluca_tpu_torch/csrc/{kernel}.cu",
                "replaces": f"fluca_tpu/ops/pallas_stencil.py:{replaces}",
                "max_abs_err": 0.0,
                "max_rel_err": {d: 0.0 for d in dtypes},
                # no one PyTorch call computes these stencils
                "library_ms": None}

    entries = {}
    for dtypes in ((torch.float32, torch.float64), (BF16,)):
        for kernel, replaces in (("poisson2d", 88), ("momentum2d", 595),
                                 ("poisson3d", 324), ("momentum3d", 830)):
            e = entry(kernel, replaces, dtypes)
            entries[e["name"]] = e
    check_poisson(entries["poisson2d"])
    check_momentum(entries["momentum2d"])
    check_poisson_bf16(entries["poisson2d_bf16"])
    check_momentum_bf16(entries["momentum2d_bf16"])
    runs = {dtype: runs3d(dtype) for dtype in (torch.float32, torch.float64)}
    check_poisson3d(entries["poisson3d"], runs)
    check_momentum3d(entries["momentum3d"], runs)
    time_kernels(entries)
    chan = runs[torch.float32][1][1]
    t32 = time_kernels3d("128^3", chan, torch.float32)
    entries["poisson3d"].update(t32["apply"])
    entries["momentum3d"].update(t32["momentum"])
    t16 = time_kernels3d("128^3", chan, BF16)
    entries["poisson3d_bf16"].update(t16["apply"])
    entries["momentum3d_bf16"].update(t16["momentum"])
    del runs, chan
    launches, cpu256 = phase_slice(smi)
    launches_bf16 = phase_slice_bf16(smi, cpu256)
    phase_budget_bf16()
    phase_inner_bf16()
    phase_app()
    launches3d, launches3d_bf16 = phase_slice3d(smi, entries)
    phase_channel512(smi, entries["poisson3d"], entries["momentum3d"],
                     profile=args.profile)
    phase_channel512_bf16(smi, entries["poisson3d_bf16"], entries["momentum3d_bf16"],
                          profile=args.profile)
    phase_app3d()
    if args.profile:
        phase_profile("cavity 256^2",
                      setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda"))
        phase_profile("cavity 64x64x32", setup_cavity_3d(
            N=(64, 64, 32), Re=100.0, dt=0.01, device="cuda"))
        phase_profile("channel 128^3", setup_channel_3d(
            N=(128, 128, 128), dt=2e-3, device="cuda"))
        phase_profile("channel 128^3 bf16 (both)", setup_channel_3d(
            N=(128, 128, 128), dt=2e-3, device="cuda"),
            bf16_precond(CNLinearConfig.production()))
    # each instance's launches in the main-path run that carries it: both
    # instances of a kernel from the same cell, the float32 and the bf16
    # preconditioner's run, at the shape of the kernel's times
    runs = {"2d": ("256x256", "cavity 256^2, 21 steps", launches),
            "2d_bf16": ("256x256", "cavity 256^2 bf16 (both), 21 steps",
                        launches_bf16),
            "3d": ("128x128x128", "channel 128^3, 11 steps", launches3d),
            "3d_bf16": ("128x128x128", "channel 128^3 bf16 (both), 11 steps",
                        launches3d_bf16)}
    for name, e in entries.items():
        shape, run, counts = runs[("3d" if "3d" in name else "2d")
                                  + ("_bf16" if name.endswith("_bf16") else "")]
        e.update(shape=shape, launches_run=run, launches=counts[name])
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "launches_run", "shape",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
