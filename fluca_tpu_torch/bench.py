"""Benchmark of fluca_tpu_torch: the Poisson SpMV against the card's own
copy, and full-step throughputs (counterpart of the repo's ``bench.py``,
cell for cell).

Primary metric (BASELINE.json's north star: Poisson SpMV at >= 80 % of
the memory roofline): the fused 2-D Poisson kernel's rate at 4096^2 f32
as a fraction of the rate of ``ops/probes.py`` ``copy_scale`` on the
same field, the fastest any kernel can stream it. Rates count one read
and one write of the field, as the reference does; ``*_frac_peak``
counts every input once and every output once over the H100's 3.35
TB/s.

Timing: the slope of host time between two counts of back-to-back
applications, each ending in ``torch.cuda.synchronize()``, so per-call
fixed costs (the synchronisation) cancel. Where the host takes longer
to issue a call than the card takes to run it, the slope is the host's
time per call.

    python -m fluca_tpu_torch.bench [--quick | --cavity | --channel3d |
                                     --channel512 | --poisson3d] [--device cuda]

prints one JSON line with the reference's metric names and the device
it ran on. The full run (no flag) exits 1 when a gate is breached:
the solve-quality ceiling ``channel512_rnorm`` and the sharded-path
ceiling ``sharded_1x1_ratio``; a gated metric that was not measured is a
breach. ``channel512_bench`` raises where its retention gate fails.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.models.cavity import setup_cavity_2d, setup_cavity_3d
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.bc import zero_velocity_bc
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.ops.probes import copy_scale
from fluca_tpu_torch.parallel.mesh import make_device_grid
from fluca_tpu_torch.parallel.sharded import build_poisson_sharded
from fluca_tpu_torch.solvers.krylov import tree_leaves
from fluca_tpu_torch.solvers.mg import PoissonMG

F32 = torch.float32
# The H100 SXM's memory rate (NVIDIA's data sheet), for the *_frac_peak
# figures.
PEAK_BYTES_PER_S = 3.35e12
# Performance floors: none. The reference's PERF_BANDS (bench.py:30-46)
# are floors measured on its TPU; the card's floors come from its own
# runs, once a benchmark harness records them.
PERF_BANDS = {}
# Ceilings (a metric must stay at or below): the 512x256x256 channel's
# per-step coupled residual, so that a faster solver that loosens the
# solve fails (bench.py:52-53); and the sharded Poisson kernel on a
# one-shard grid against the unsharded kernel (bench.py:54-57).
PERF_CEILINGS = {"channel512_rnorm": 500.0, "sharded_1x1_ratio": 1.15}
# The 512x256x256 channel's mean-flow retention gate over its first 11
# steps (bench.py:474-480).
RETENTION_MIN = 0.9
# The solver the reference ships for the 512x256x256 channel, its first
# attempt (bench.py:450-451): production(outer 2, Jacobi momentum 6,
# CG Schur 8) with the bf16 preconditioner on the momentum solve.
CHANNEL512_SOLVER = "o2+jac6s8+bf16mom"


def device_info(device) -> dict:
    """The device a result was measured on."""
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def _sync(x) -> None:
    """Wait for the device that holds the leaves of ``x``."""
    dev = tree_leaves(x)[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def slope_time_per_iter(fn, x, iters_lo=50, iters_hi=400, repeats=3):
    """Seconds per application of ``fn`` (x -> fn(x), chained), fixed
    overheads removed: the slope between ``iters_lo`` and ``iters_hi``
    applications, each count timed best of ``repeats`` after a warm-up
    run (bench.py:109)."""
    def run(iters):
        y = x
        for _ in range(iters):
            y = fn(y)
        _sync(y)

    ts = {}
    for iters in (iters_lo, iters_hi):
        run(iters)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(iters)
            best = min(best, time.perf_counter() - t0)
        ts[iters] = best
    return (ts[iters_hi] - ts[iters_lo]) / (iters_hi - iters_lo)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _coeff_bytes(c) -> int:
    return _nbytes(*(t for t in vars(c).values() if torch.is_tensor(t)))


def _roofline(mg, x, rows, iters) -> dict:
    """The level-0 Poisson apply of ``mg`` against ``copy_scale`` on
    ``x``, ``rows`` rows per block."""
    t_copy = slope_time_per_iter(lambda a: copy_scale(a, rows=rows), x, *iters)
    t_spmv = slope_time_per_iter(mg.apply_op, x, *iters)
    field = _nbytes(x)
    every = 2 * field + _coeff_bytes(mg.levels[0].coeffs)
    gbps_copy = 2 * field / t_copy / 1e9
    gbps_spmv = 2 * field / t_spmv / 1e9
    return {
        "frac": gbps_spmv / gbps_copy,
        "gbps_copy": gbps_copy,
        "gbps_spmv": gbps_spmv,
        "us_per_apply": t_spmv * 1e6,
        "us_per_copy": t_copy * 1e6,
        "copy_frac_peak": 2 * field / t_copy / PEAK_BYTES_PER_S,
        "spmv_frac_peak": every / t_spmv / PEAK_BYTES_PER_S,
    }


def spmv_roofline(N=4096, device="cuda") -> dict:
    """The 2-D Poisson apply at N^2 f32 (walls) against the copy in
    128-row blocks (bench.py:139)."""
    mesh = CartMesh.create((N, N))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    mg = PoissonMG(mesh, [zero_velocity_bc()] * 4, scale=1.0, dtype=F32, device=device)
    x = torch.ones((N, N), dtype=F32, device=device)
    return {**_roofline(mg, x, 128, (50, 400)), "N": N}


def poisson3d_roofline(N=256, device="cuda") -> dict:
    """The 3-D Poisson apply at N^3 f32 (walls) against the copy in
    8-plane blocks (bench.py:542)."""
    mesh = CartMesh.create((N, N, N))
    mesh.set_uniform_coordinates(0, 1, 0, 1, 0, 1)
    mg = PoissonMG(mesh, [zero_velocity_bc()] * 6, scale=1.0, dtype=F32, device=device)
    x = torch.ones((N, N, N), dtype=F32, device=device)
    r = _roofline(mg, x, 8, (20, 150))
    return {
        "metric": "poisson3d_spmv_roofline_fraction",
        "value": r["frac"],
        "unit": (f"fraction of the card's copy ({r['gbps_copy']:.0f} GB/s); spmv "
                 f"{r['gbps_spmv']:.0f} GB/s at {r['us_per_apply']:.0f} us/apply, "
                 f"{N}^3 f32"),
        "vs_baseline": r["frac"] / 0.80,
        **r,
        "N": N,
        "device": device_info(device),
    }


def sharded_1x1_ratio(N=4096, device="cuda") -> dict:
    """The sharded Poisson kernel on a one-shard grid against the
    unsharded kernel, at N^2 f32 (bench.py:196): the halo path must
    cost nothing when the grid is trivial."""
    mesh = CartMesh.create((N, N))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    mg = PoissonMG(mesh, [zero_velocity_bc()] * 4, scale=1.0, dtype=F32, device=device)
    f_sh = build_poisson_sharded(make_device_grid(2, [device]), mg.levels[0], mode="apply")
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((N, N), generator=gen, dtype=F32, device=device)
    err = float((mg.apply_op(x) - f_sh(x)).abs().max())
    if not err < 1e-6:
        raise RuntimeError(f"sharded(1x1) mismatch: max abs {err}")
    t_un = slope_time_per_iter(mg.apply_op, x, 20, 150)
    t_sh = slope_time_per_iter(f_sh, x, 20, 150)
    return {"ratio": t_sh / t_un, "us_unsharded": t_un * 1e6, "us_sharded": t_sh * 1e6}


def _advance_throughput(ns, steps) -> float:
    """Warm steps/s of ``advance(steps)``, best of 3, each window ending
    in one scalar read of the final state (bench.py:313)."""
    ns.step()
    ns.advance(steps)
    float(ns.state["v"][0].sum())
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ns.advance(steps)
        float(ns.state["v"][0].sum())
        best = min(best, time.perf_counter() - t0)
    return steps / best


def cavity_throughput(N=256, steps=50, capped=True, device="cuda") -> float:
    """The 2-D cavity (Re 100, dt 0.01) in steps/s, production preset
    unless ``capped`` is False (bench.py:339)."""
    ns = setup_cavity_2d(N=N, Re=100.0, dt=0.01, max_steps=10 * steps + 1, dtype=F32,
                         device=device)
    if capped:
        ns.impl.cfg = CNLinearConfig.production()
    return _advance_throughput(ns, steps)


def cavity3d_throughput(N=(64, 64, 32), steps=30, device="cuda") -> float:
    """The 3-D cavity of cavity_flow_3d.c in steps/s, production
    preset (bench.py:356)."""
    ns = setup_cavity_3d(N=N, Re=100.0, dt=0.01, max_steps=10 * steps + 1, dtype=F32,
                         device=device)
    ns.impl.cfg = CNLinearConfig.production()
    return _advance_throughput(ns, steps)


def channel_throughput(N=128, steps=30, fast=False, bf16=False, device="cuda") -> float:
    """The N^3 channel (dt 2e-3) in steps/s (bench.py:369): production,
    ``fast`` the production_fast preset, ``bf16`` production with the
    bf16 preconditioner on both inner solves."""
    ns = setup_channel_3d(N=(N, N, N), dt=2e-3, max_steps=10**9, dtype=F32, device=device)
    cfg = CNLinearConfig.production_fast() if fast else CNLinearConfig.production()
    if bf16:
        cfg.precond_dtype = "bfloat16"
    ns.impl.cfg = cfg
    return _advance_throughput(ns, steps)


def channel512_bench(steps=20, N=(512, 256, 256), device="cuda") -> dict:
    """BASELINE config #5: the wall-clustered channel (stretch_y 2.0,
    dt 5e-5, float32) with the solver the reference ships for it
    (``CHANNEL512_SOLVER``), and the 3-D Poisson apply's rate at its
    shape beside the card's copy there (bench.py:395). Only that solver
    runs: the reference's walk down a list of fallback solvers
    (bench.py:450-488) would hide a failure. Raises where the mean flow
    does not keep ``RETENTION_MIN`` of itself over 11 steps, where the
    fields go non-finite, and, on the card, where the Poisson kernel
    was not launched."""
    device = torch.device(device)
    ns = setup_channel_3d(N=N, dt=5e-5, max_steps=10**9, stretch_y=2.0, dtype=F32,
                          device=device)
    cfg = CNLinearConfig.production(2, 6, 8)
    cfg.mom_solver = "jacobi"
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = "mom"
    ns.impl.cfg = cfg
    u0 = float(ns.state["v"][0].abs().mean())
    ns.step()
    ns.advance(10)
    u1 = float(ns.state["v"][0].abs().mean())
    if not (math.isfinite(u1) and u1 >= RETENTION_MIN * u0):
        raise RuntimeError(f"channel512 {CHANNEL512_SOLVER}: mean flow {u0:.6g} -> "
                           f"{u1:.6g} in 11 steps (retention gate {RETENTION_MIN})")
    cuda_stencil.reset_launch_counts()
    sps = _advance_throughput(ns, steps)
    n_steps = 1 + 4 * steps
    kernels = {k: n / n_steps for k, n in cuda_stencil.launch_counts().items() if n}
    if device.type == "cuda" and not kernels.get("poisson3d_f32"):
        raise RuntimeError(f"channel512: the Poisson 3-D kernel was not launched: {kernels}")
    rnorm = float(ns.last_diag["ksp_rnorm"])
    x = torch.zeros(ns.mesh.cell_shape, dtype=F32, device=device)
    t_spmv = slope_time_per_iter(ns.impl.mg.apply_op, x, 20, 120)
    t_copy = slope_time_per_iter(lambda a: copy_scale(a, rows=8), x, 20, 120)
    cells = math.prod(N)
    return {
        "steps_per_sec": sps,
        "ms_per_step": 1e3 / sps,
        "mcells_per_sec": cells * sps / 1e6,
        "spmv_gbps": 2 * cells * 4 / t_spmv / 1e9,
        "copy_roofline_at_shape_gbps": 2 * cells * 4 / t_copy / 1e9,
        "solver": CHANNEL512_SOLVER,
        "ksp_rnorm": rnorm,
        "retention": u1 / u0,
        "grid": list(N),
        "kernels": kernels,
    }


def check_gates(values) -> int:
    """The number of breached gates of ``values`` (0 = pass), each
    printed: a floor of PERF_BANDS or a ceiling of PERF_CEILINGS not
    met, or a gated metric that was not measured."""
    bad = 0
    for key, limit, ok in ([(k, v, lambda got, v=v: got >= v) for k, v in PERF_BANDS.items()]
                           + [(k, v, lambda got, v=v: got <= v)
                              for k, v in PERF_CEILINGS.items()]):
        got = values.get(key)
        if got is None:
            print(f"PERF GATE: {key} was not measured (limit {limit}): a breach",
                  file=sys.stderr)
            bad += 1
        elif not ok(got):
            print(f"PERF GATE: {key} = {got} breaches its limit {limit}", file=sys.stderr)
            bad += 1
    return bad


def full_run(device) -> dict:
    """The full-step cells of bench.py main (bench.py:241-289), keyed as
    there."""
    out = {
        "cavity2d_256_steps_per_sec": cavity_throughput(N=256, steps=50, device=device),
        "cavity3d_64_steps_per_sec": cavity3d_throughput(N=(64, 64, 32), steps=30,
                                                         device=device),
        "channel3d_128_steps_per_sec": channel_throughput(N=128, steps=30, device=device),
        "channel3d_128_bf16_steps_per_sec": channel_throughput(N=128, steps=30, bf16=True,
                                                               device=device),
        "channel3d_128_fast_steps_per_sec": channel_throughput(N=128, steps=30, fast=True,
                                                               device=device),
    }
    r512 = channel512_bench(device=device)
    out.update(channel512_steps_per_sec=r512["steps_per_sec"],
               channel512_spmv_gbps=r512["spmv_gbps"],
               channel512_copy_gbps=r512["copy_roofline_at_shape_gbps"],
               channel512_mcells_per_sec=r512["mcells_per_sec"],
               channel512_solver=r512["solver"],
               channel512_rnorm=r512["ksp_rnorm"],
               channel512_kernels=r512["kernels"])
    s = sharded_1x1_ratio(device=device)
    out.update(sharded_1x1_ratio=s["ratio"], sharded_1x1_us=s["us_sharded"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cell = ap.add_mutually_exclusive_group()
    for flag, what in (("--quick", "the SpMV roofline only"),
                       ("--cavity", "the 256^2 cavity's steps/s"),
                       ("--channel3d", "the 128^3 channel's steps/s"),
                       ("--channel512", "the 512x256x256 channel"),
                       ("--poisson3d", "the 3-D SpMV roofline at 256^3")):
        cell.add_argument(flag, action="store_true", help=what)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    dev = device_info(device)

    if args.cavity:
        line = {"metric": "cavity_timesteps_per_sec", "value": cavity_throughput(device=device),
                "unit": "steps/s (256x256 f32, Re=100, production preset)",
                "vs_baseline": None}
    elif args.channel3d:
        line = {"metric": "channel3d_timesteps_per_sec",
                "value": channel_throughput(device=device),
                "unit": "steps/s (128^3 f32, production preset)", "vs_baseline": None}
    elif args.channel512:
        r = channel512_bench(device=device)
        line = {"metric": "channel512_timesteps_per_sec", "value": r["steps_per_sec"],
                "unit": (f"steps/s (512x256x256 f32, {r['solver']}, {r['ms_per_step']:.1f} "
                         f"ms/step, {r['mcells_per_sec']:.1f} Mcells/s; stencil SpMV "
                         f"{r['spmv_gbps']:.1f} GB/s, the card's copy "
                         f"{r['copy_roofline_at_shape_gbps']:.1f} GB/s at this shape)"),
                "vs_baseline": None, **r}
    elif args.poisson3d:
        line = poisson3d_roofline(device=device)
    else:
        r = spmv_roofline(device=device)
        extra = {} if args.quick else full_run(device)
        line = {
            "metric": "poisson_spmv_roofline_fraction",
            "value": r["frac"],
            "unit": (f"fraction of the card's copy ({r['gbps_copy']:.0f} GB/s); spmv "
                     f"{r['gbps_spmv']:.0f} GB/s at {r['us_per_apply']:.1f} us/apply, "
                     f"{r['N']}x{r['N']} f32; extra: full-step steps/s at the "
                     f"fixed-budget production preset"),
            "vs_baseline": r["frac"] / 0.80,
            **{k: v for k, v in r.items() if k not in ("frac", "N")},
            **extra,
        }
    line["device"] = dev
    print(json.dumps(line), flush=True)
    full = not (args.quick or args.cavity or args.channel3d or args.channel512
                or args.poisson3d)
    return 1 if full and check_gates(line) else 0


if __name__ == "__main__":
    sys.exit(main())
