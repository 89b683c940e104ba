"""Warm steps/s of the 2-D Re-100 lid-driven cavity (cavity_flow_2d.c) at
256^2, dt 0.01, and 2048^2, dt 0.00125 (the same lid CFL, 2.56), under
the two solvers chip_smoke.py's 2-D slice runs: float32 production(),
and production() with the bf16 preconditioner on both inner solves. Each
run takes one step and advance(warm - 1), then advance(steps) timed
between synchronisations, and reports the launches of that window per
step, by kernel instance; the fields must stay finite. On a CUDA device
two more steps run under torch.profiler: the device's busy ms per step,
its idle share of the wall time, and the 2-D kernels' device ms per
step.

    python -m fluca_tpu_torch.examples.steps2d [--sizes 256,2048]
        [--device cuda] [--out PATH]

Run by its path with another checkout's root on PYTHONPATH, it times
that checkout's fluca_tpu_torch (its kernels built in its own build/),
so that two commits can be timed in turns on one card, one process
each (A, B, B, A):

    PYTHONPATH=OTHER_CHECKOUT python fluca_tpu_torch/examples/steps2d.py
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

import fluca_tpu_torch
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.cavity import setup_cavity_2d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil

# cells per side: (dt, warm steps, timed steps)
SIZES = {256: (0.01, 5, 40), 2048: (0.00125, 3, 20)}
SOLVERS = ("f32_production", "bf16_both")


def solver(label: str) -> CNLinearConfig:
    """The configuration of the run ``label``."""
    cfg = CNLinearConfig.production()
    if label == "bf16_both":
        cfg.precond_dtype = "bfloat16"
        cfg.precond_scope = "both"
    return cfg


def run(N, label, device) -> dict:
    """Steps/s and launches per step of the N^2 cavity under ``label``."""
    dt, warm, steps = SIZES[N]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ns = setup_cavity_2d(N=N, Re=100.0, dt=dt, max_steps=10**9, dtype=torch.float32,
                         device=device)
    ns.impl.cfg = solver(label)
    ns.step()
    ns.advance(warm - 1)
    sync()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    ns.advance(steps)
    sync()
    seconds = time.perf_counter() - t0
    if not all(bool(torch.isfinite(x).all()) for x in (*ns.state["v"], ns.state["p"])):
        raise RuntimeError(f"{N}^2 {label}: the fields went non-finite")
    out = {"steps_per_sec": steps / seconds, "steps": steps,
           "launches_per_step": {k: n / steps for k, n in cuda_stencil.launch_counts().items()
                                 if n}}
    if device.type == "cuda":
        out.update(profiled(ns, sync))
    return out


def profiled(ns, sync, steps=2) -> dict:
    """Device busy ms per step over ``steps`` steps under torch.profiler,
    its idle share of the wall time, and the 2-D kernels' device ms per
    step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ns.advance(steps)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    kernels = {name: sum(e.self_device_time_total for e in events
                         if f"{name}_kernel" in e.key) / 1e3 / steps
               for name in ("poisson2d", "momentum2d")}
    return {"device_busy_ms_per_step": busy / steps, "idle_share": 1 - busy / wall,
            "kernel_ms_per_step": kernels,
            "device_launches_per_step": sum(e.count for e in events) / steps}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--sizes", default="256,2048", help="cells per side, comma separated")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    out = {"package": str(Path(fluca_tpu_torch.__file__).resolve().parent)}
    for N in (int(n) for n in args.sizes.split(",")):
        for label in SOLVERS:
            out[f"{N}x{N} {label}"] = run(N, label, device)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    emit(out, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
