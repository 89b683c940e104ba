"""Device time of the two 2-D kernels through the wrappers a solver calls:
the Poisson 2-D modes (apply, residual, smooth) in float32, float64 and
bf16 at 4096^2 and on every level of the 256^2 cavity's multigrid
hierarchy; the momentum 2-D apply in the three instances at 4096^2
(random planes) and 256^2 (the planes of a cavity step); and the halo
instances (float32, float64) at 4096^2 on a (4, 2) and a one-shard grid,
their launches alone (edge planes given). Random fields from a seed;
each time is the mean of launches captured in a CUDA graph.

    python -m fluca_tpu_torch.examples.kernels2d [--plans] [--save-outputs PATH]
        [--compare-outputs PATH] [--device cuda] [--out PATH]

``--plans`` also times both kernels at 4096^2 (f32, f64 and bf16) and at
256^2 (f32) under a sweep of (rows, run) beside the wrappers' own plans,
each launch held at max abs difference 0 against the wrapper's.
``--save-outputs`` writes every instance's output on seeded inputs (the
wall-bounded 256^2 and periodic 1024^2 and 37x29 grids, and the halo
instances on (4, 2)) to PATH; ``--compare-outputs`` computes the same and
reports, per instance, the max abs difference from the outputs in PATH:
run one checkout with the first and another with the second to hold two
kernels bit for bit.

Run by its path with another checkout's root on PYTHONPATH, it times
that checkout's kernels (built in its own build/), so that two commits
can be timed in turns on one card, one process each (A, B, B, A):

    PYTHONPATH=OTHER_CHECKOUT python fluca_tpu_torch/examples/kernels2d.py

(``--plans`` needs this checkout's launch plans.) Prints one JSON line:
ms per call by kernel, shape, instance and mode.
"""

from __future__ import annotations

import ctypes
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

import fluca_tpu_torch
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.models.cavity import setup_cavity_2d
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil as cs
from fluca_tpu_torch.parallel.mesh import make_device_grid
from fluca_tpu_torch.parallel.sharded import field_edges, halo_layout
from fluca_tpu_torch.solvers import mg as mg_mod

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
NAMES = {F32: "f32", F64: "f64", BF16: "bf16"}
ROWS = (1, 2, 4, 8)
RUNS = (1, 4, 8, 16, 32, 64)


def graph_ms(fn, calls, replays) -> float:
    """Device ms of one fn() call: ``calls`` calls in a CUDA graph,
    replayed ``replays`` times between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def eager_ms(fn, iters=1000, repeats=5) -> float:
    """ms per eager fn() call by CUDA events around ``iters`` calls, the
    least of ``repeats``: where the host takes longer to issue a call than
    the device to run it (the 256^2 levels), the host's time per call."""
    for _ in range(20):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def reps_for(n) -> tuple[int, int]:
    """(calls, replays) for a field of ``n`` cells."""
    return (10, 10) if n >= 2048 * 2048 else (50, 20)


def unit_mesh(shape, periodic=(False, False)):
    mesh = CartMesh.create(shape, periodic)
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    return mesh


def level(shape, periodic, dtype, device, scale=0.01):
    """The finest multigrid level of a unit square of ``shape`` cells
    (walls, or periodic on the axes ``periodic`` names), fields in
    ``dtype``."""
    mesh = unit_mesh(shape, periodic)
    wall, per = zero_velocity_bc(), BoundaryCondition(BCType.PERIODIC)
    bcs = [per if periodic[0] else wall] * 2 + [per if periodic[1] else wall] * 2
    return mg_mod._build_level(mesh, T_.axis_bcs(mesh, bcs), scale, dtype, device)


def fields(shape, dtype, gen, n=2):
    dev = gen.device
    return [torch.randn(shape, generator=gen, device=dev, dtype=F64).to(dtype)
            for _ in range(n)]


def mode_args(mode, b, w):
    return {"apply": (), "residual": (b,), "smooth": (b, w)}[mode]


def poisson_modes(c, inv_diag, gen) -> dict:
    """ms per call of each mode, fields in ``inv_diag``'s dtype."""
    p, b = fields(c.shape, inv_diag.dtype, gen)
    reps = reps_for(p.numel())
    return {mode: graph_ms(lambda: cs.poisson2d(mode, p, c, *mode_args(mode, b, inv_diag),
                                                omega=0.8), *reps)
            for mode in cs.POISSON_MODES}


def cavity_planes(N, device):
    """The momentum plane stack of the N^2 cavity after 2 production
    steps, float32."""
    ns = setup_cavity_2d(N=N, Re=100.0, dt=0.01, device=device)
    ns.impl.cfg = CNLinearConfig.production()
    ns.advance(2)
    ops = ns.impl.ops
    Bv0, bcB = ops.apply_B(ns.state["v"]), ops.bc_B(ns.t)
    v0f = tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(2)) for d in range(2))
    return ops.build_momentum_coeffs_stacked(ns.state["U"], v0f)


def random_planes(N, gen):
    """26 random planes with the +-2 ones zero, as off the walls."""
    W = torch.randn((cs.MOMENTUM_PLANES, N, N), generator=gen, device=gen.device)
    W[18:] = 0.0
    return W


def halo_launches(N, grid_shape, gen) -> dict:
    """ms per call of the halo instances' launches (edge planes given) at
    N^2 on a device grid of ``grid_shape``, float32 and float64."""
    out = {}
    for dtype in (F32, F64):
        lvl = level((N, N), (False, False), dtype, gen.device)
        grid = make_device_grid(2, [gen.device], shape=grid_shape)
        layout = halo_layout(grid, lvl.mesh)
        p, b = fields(lvl.mesh.N, dtype, gen)
        edges = field_edges(layout, p)
        reps = reps_for(p.numel())
        key = f"{N}x{N} on {grid_shape} {NAMES[dtype]}"
        out[f"poisson2d_halo {key}"] = {
            mode: graph_ms(lambda: cs.poisson2d_halo(mode, p, lvl.coeffs, layout, edges,
                                                     *mode_args(mode, b, lvl.inv_diag),
                                                     omega=0.8), *reps)
            for mode in cs.POISSON_MODES}
        del lvl, b
        W = random_planes(N, gen).to(dtype)
        v = p.clone()
        ve = field_edges(layout, v)
        out[f"momentum2d_halo {key}"] = graph_ms(
            lambda: cs.momentum2d_halo(W, p, v, layout, edges, ve), *reps)
        del W, p, v, edges, ve
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# outputs for the bit-for-bit comparison of two checkouts

def outputs(device) -> dict:
    """Every instance's output on seeded inputs, on the CPU: the Poisson
    modes and the momentum apply (f32, f64, bf16) on a wall-bounded 256^2,
    a periodic 1024^2 and a 37x29 grid periodic along axis 0, and the halo
    instances (f32, f64) at 256^2 on (4, 2), walls and periodic."""
    rng = np.random.default_rng(7)
    out = {}

    def arr(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape), device=device).to(dtype)

    for N, per in (((256, 256), (False, False)), ((1024, 1024), (True, True)),
                   ((37, 29), (True, False))):
        for dtype in (F32, F64, BF16):
            lvl = level(N, per, dtype, device)
            p, b = arr(N, dtype), arr(N, dtype)
            tag = f"{N[0]}x{N[1]} periodic {per} {NAMES[dtype]}"
            for mode in cs.POISSON_MODES:
                out[f"poisson2d {mode} {tag}"] = cs.poisson2d(
                    mode, p, lvl.coeffs, *mode_args(mode, b, lvl.inv_diag), omega=0.8).cpu()
            W = arr((cs.MOMENTUM_PLANES, *N), dtype)
            ou, ov = cs.momentum2d(W, p, b, per)
            out[f"momentum2d {tag}"] = torch.stack([ou, ov]).cpu()
    for per in (False, True):
        for dtype in (F32, F64):
            lvl = level((256, 256), (per, per), dtype, device)
            layout = halo_layout(make_device_grid(2, [device], shape=(4, 2)), lvl.mesh)
            p, b = arr((256, 256), dtype), arr((256, 256), dtype)
            edges = field_edges(layout, p)
            tag = f"256x256 on (4, 2) periodic {per} {NAMES[dtype]}"
            for mode in cs.POISSON_MODES:
                out[f"poisson2d_halo {mode} {tag}"] = cs.poisson2d_halo(
                    mode, p, lvl.coeffs, layout, edges, *mode_args(mode, b, lvl.inv_diag),
                    omega=0.8).cpu()
            W = arr((cs.MOMENTUM_PLANES, 256, 256), dtype)
            W[18:] = 0.0  # no +-2 read past an edge plane meets a nonzero plane
            ou, ov = cs.momentum2d_halo(W, p, b, layout, edges, field_edges(layout, b))
            out[f"momentum2d_halo {tag}"] = torch.stack([ou, ov]).cpu()
    return out


def compare(mine, theirs) -> dict:
    """Per instance, the max abs difference of two ``outputs``."""
    if set(mine) != set(theirs):
        raise RuntimeError(f"the outputs differ in their keys: {set(mine) ^ set(theirs)}")
    return {k: float((mine[k].double() - theirs[k].double()).abs().max()) for k in mine}


# ----------------------------------------------------------------------
# launch-plan sweeps (this checkout's plans)

def plan_of(shape, rows, run, vec, reach, smem_per_row) -> cs.March2DPlan:
    """``rows`` warps per block and runs of about ``run`` rows over
    ``shape``, ``vec`` cells per lane."""
    strips = -(-shape[1] // cs.march2d_columns(reach, vec))
    gy = -(-shape[0] // run)
    run = -(-shape[0] // gy)
    return cs.March2DPlan((-(-strips // rows), gy), rows, run, vec, smem_per_row * run)


def sweep(label, shape, dtype, reach, smem_per_row, launch, ref) -> dict:
    """ms of ``launch(plan)`` under every (rows, run, vec) of the sweep,
    each output equal to ``ref``."""
    times = {}
    # the cells per lane each kernel has an instance for (at most 16 bytes)
    vecs = [v for v in (1, 2, 4) if v * dtype.itemsize <= 16]
    reps = reps_for(shape[0] * shape[1])
    for vec in vecs:
        if shape[1] % vec:
            continue
        for rows in ROWS:
            for run in RUNS:
                if run > shape[0]:
                    continue
                plan = plan_of(shape, rows, run, vec, reach, smem_per_row)
                for a, b in zip(launch(plan), ref):
                    if not torch.equal(a, b):
                        raise RuntimeError(f"{label}: the plan {plan} changed the result")
                times[f"vec {vec} rows {rows} run {run}"] = graph_ms(lambda: launch(plan), *reps)
    return times


def poisson_sweep(N, dtype, gen) -> dict:
    lvl = level((N, N), (False, False), dtype, gen.device)
    c = lvl.coeffs
    p, b = fields(c.shape, dtype, gen)
    entry = cs.poisson2d._entry(NAMES[dtype])
    out = {}
    for mode in cs.POISSON_MODES:
        bb = b if mode != "apply" else None
        ww = lvl.inv_diag if mode == "smooth" else None
        ref = cs.poisson2d(mode, p, c, bb, ww, 0.8)

        def launch(plan):
            o = torch.empty_like(p)
            ptrs = [t if t is None else t.data_ptr() for t in (p, bb, ww, c.rx, c.ry, c.cy,
                                                               c.cyb, o)]
            err = entry(cs.POISSON_MODES[mode], (ctypes.c_void_p * 8)(*ptrs), N, N, 0, 0,
                        0.8, plan.as_c(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"poisson2d: cudaError {err}")
            return (o,)

        out[mode] = sweep(f"poisson2d {mode} {N}^2", (N, N), dtype, 1,
                          4 * cs.coef_dtype(dtype).itemsize, launch, (ref,))
    return out


def momentum_sweep(N, dtype, gen) -> dict:
    W = random_planes(N, gen).to(dtype)
    u, v = fields((N, N), dtype, gen)
    ref = cs.momentum2d(W, u, v, (False, False))
    entry = cs.momentum2d._entry(NAMES[dtype])

    def launch(plan):
        o = (torch.empty_like(u), torch.empty_like(v))
        ptrs = [t.data_ptr() for t in (W, u, v, *o)]
        err = entry((ctypes.c_void_p * 5)(*ptrs), N, N, 0, 0, plan.as_c(),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"momentum2d: cudaError {err}")
        return o

    return sweep(f"momentum2d {N}^2", (N, N), dtype, 2, 0, launch, ref)


def halo_sweep(N, gen) -> dict:
    """The halo instances' launches (f32) at N^2 on (4, 2) under the
    wrappers' plans with every (rows, run) of the sweep: ms by kernel,
    rows and run."""
    out = {}
    for kernel, plan_fn in (("poisson2d", "poisson2d_launch_plan"),
                            ("momentum2d", "momentum2d_launch_plan")):
        own = getattr(cs, plan_fn)
        lvl = level((N, N), (False, False), F32, gen.device)
        layout = halo_layout(make_device_grid(2, [gen.device], shape=(4, 2)), lvl.mesh)
        p, b = fields(lvl.mesh.N, F32, gen)
        edges, be = field_edges(layout, p), field_edges(layout, b)
        W = random_planes(N, gen) if kernel == "momentum2d" else None
        reps = reps_for(p.numel())
        base = own(layout.local, F32)
        strips = -(-layout.local[1] // cs.march2d_columns(1 if kernel == "poisson2d" else 2,
                                                          base.vec))
        times = {}
        try:
            for rows in ROWS[:3]:
                for run in RUNS[:4]:
                    plan = plan_of(layout.local, rows, run, base.vec,
                                   1 if kernel == "poisson2d" else 2,
                                   base.smem // base.run)
                    assert plan.grid[0] == -(-strips // rows)
                    setattr(cs, plan_fn, lambda *a, plan=plan: plan)
                    tag = f"rows {rows} run {run}"
                    if kernel == "poisson2d":
                        times[f"apply {tag}"] = graph_ms(lambda: cs.poisson2d_halo(
                            "apply", p, lvl.coeffs, layout, edges), *reps)
                        times[f"smooth {tag}"] = graph_ms(lambda: cs.poisson2d_halo(
                            "smooth", p, lvl.coeffs, layout, edges, b, lvl.inv_diag, 0.8),
                            *reps)
                    else:
                        times[tag] = graph_ms(lambda: cs.momentum2d_halo(
                            W, p, b, layout, edges, be), *reps)
        finally:
            setattr(cs, plan_fn, own)
        out[f"{kernel}_halo {N}x{N} on (4, 2) f32"] = times
        del lvl, p, b, W, edges, be
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--plans", action="store_true", help="also sweep the launch plans")
    ap.add_argument("--save-outputs", default=None, help="write every instance's output here")
    ap.add_argument("--compare-outputs", default=None,
                    help="compare every instance's output with the ones written here")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("kernels2d times CUDA kernels: it needs a CUDA device")
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"package": str(Path(fluca_tpu_torch.__file__).resolve().parent),
              "poisson2d": {}, "momentum2d": {}, "halo": {}}
    if args.save_outputs or args.compare_outputs:
        mine = outputs(device)
        if args.save_outputs:
            torch.save(mine, args.save_outputs)
        if args.compare_outputs:
            result["max_abs_vs_saved"] = compare(mine, torch.load(args.compare_outputs))
        del mine
    for dtype in (F32, F64, BF16):
        lvl = level((4096, 4096), (False, False), dtype, device)
        result["poisson2d"][f"4096x4096 {NAMES[dtype]}"] = poisson_modes(
            lvl.coeffs, lvl.inv_diag, gen)
        del lvl
        mg = mg_mod.PoissonMG(unit_mesh((256, 256)), [zero_velocity_bc()] * 4, scale=0.01,
                              dtype=dtype, device=device)
        for lv in mg.levels:
            key = "x".join(map(str, lv.coeffs.shape))
            result["poisson2d"][f"{key} {NAMES[dtype]}"] = poisson_modes(lv.coeffs, lv.inv_diag,
                                                                         gen)
        del mg
        torch.cuda.empty_cache()
    lvl = level((256, 256), (False, False), F32, device)
    p, b = fields((256, 256), F32, gen)
    result["eager_ms_256"] = {
        mode: eager_ms(lambda: cs.poisson2d(mode, p, lvl.coeffs, *mode_args(mode, b, lvl.inv_diag),
                                            omega=0.8))
        for mode in cs.POISSON_MODES}
    planes256 = cavity_planes(256, device)
    result["eager_ms_256"]["momentum"] = eager_ms(
        lambda: cs.momentum2d(planes256, p, b, (False, False)))
    del lvl, p, b
    for dtype in (F32, F64, BF16):
        W = random_planes(4096, gen).to(dtype)
        u, v = fields((4096, 4096), dtype, gen)
        result["momentum2d"][f"4096x4096 {NAMES[dtype]} (random planes)"] = graph_ms(
            lambda: cs.momentum2d(W, u, v, (False, False)), *reps_for(u.numel()))
        del W, u, v
        torch.cuda.empty_cache()
        W = planes256.to(dtype)
        u, v = fields((256, 256), dtype, gen)
        result["momentum2d"][f"256x256 {NAMES[dtype]} (cavity planes)"] = graph_ms(
            lambda: cs.momentum2d(W, u, v, (False, False)), *reps_for(u.numel()))
    for grid_shape in ((4, 2), (1, 1)):
        result["halo"].update(halo_launches(4096, grid_shape, gen))
    if args.plans:
        result["sweep"] = {}
        result["plans"] = {}
        for N, dtype in ((4096, F32), (4096, BF16), (4096, F64), (256, F32)):
            key = f"{N}x{N} {NAMES[dtype]}"
            result["sweep"][f"poisson2d {key}"] = poisson_sweep(N, dtype, gen)
            result["sweep"][f"momentum2d {key}"] = momentum_sweep(N, dtype, gen)
            result["plans"][f"poisson2d {key}"] = asdict(cs.poisson2d_launch_plan((N, N), dtype))
            result["plans"][f"momentum2d {key}"] = asdict(cs.momentum2d_launch_plan((N, N), dtype))
            torch.cuda.empty_cache()
        result["sweep"].update(halo_sweep(4096, gen))
    emit(result, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
