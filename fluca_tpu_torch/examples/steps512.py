"""Warm steps/s of the 512x256x256 channel (BASELINE config #5) under
the two solvers that chip_smoke.py times there: float32
production(3, 8, 6), and the solver the reference ships for this
channel (production(2, 6, 8), Jacobi momentum, the bf16 preconditioner
on the momentum solve). The window is chip_smoke.py's: one step and
advance(71), then advance(20) timed between synchronisations (steps
73-92).

    python -m fluca_tpu_torch.examples.steps512 [--grid 512x256x256]
        [--device cuda] [--out PATH]

Run by its path with another checkout's root on PYTHONPATH, it times
that checkout's fluca_tpu_torch (its kernels built in its own build/),
so that two commits can be timed in turns on one card, one process
each (A, B, B, A):

    PYTHONPATH=OTHER_CHECKOUT python fluca_tpu_torch/examples/steps512.py
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

import fluca_tpu_torch
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device


def solver(label: str) -> CNLinearConfig:
    """The configuration of the run ``label``."""
    if label == "f32_production_3_8_6":
        return CNLinearConfig.production(3, 8, 6)
    cfg = CNLinearConfig.production(2, 6, 8)
    cfg.mom_solver = "jacobi"
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = "mom"
    return cfg


def steps_per_sec(ns, sync, steps=20, warm=72) -> float:
    """Steps/s of ``advance(steps)`` after ``warm`` steps."""
    ns.step()
    ns.advance(warm - 1)
    sync()
    t0 = time.perf_counter()
    ns.advance(steps)
    sync()
    return steps / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--grid", default="512x256x256", help="cells, N0xN1xN2")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    N = tuple(int(n) for n in args.grid.split("x"))
    # which checkout ran
    out = {"package": str(Path(fluca_tpu_torch.__file__).resolve().parent), "grid": list(N)}
    for label in ("f32_production_3_8_6", "bf16_momentum_shipped"):
        ns = setup_channel_3d(N=N, dt=5e-5, max_steps=10**9, stretch_y=2.0,
                              dtype=torch.float32, device=device)
        ns.impl.cfg = solver(label)
        out[f"{label}_steps_per_sec"] = steps_per_sec(ns, sync)
        if not all(bool(torch.isfinite(x).all()) for x in ns.state["v"]):
            raise RuntimeError(f"{label}: the fields went non-finite")
        del ns
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit(out, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
