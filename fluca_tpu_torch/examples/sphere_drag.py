"""BASELINE config #4 at its stated size: flow past a sphere at Re 100 on
a 128^3 grid (``--N``: another cells per axis, for a grid study at fixed L
and retraction), multigrid-preconditioned Poisson, checkpoint and CGNS
I/O (counterpart of examples/sphere_drag.py and its FLUCA_TPU_SPHERE_N).

Setup: cube domain L^3 (``--L``, default 4: 16 cells per diameter), the
sphere D 0.5 at (0.375 L, L/2, L/2) ((1.5, 2, 2) at L 4), its markers
``--retract`` (0.5) cell widths inside the surface (Breugem 2012),
inflow / pressure outlet in x, symmetry on the lateral planes, dt 8e-3,
float32 production(3, 8, 8), from uniform flow.

It advances in chunks of CHUNK steps until C_D settles (after t = 12,
three readings within 3e-4 of each other; the reference's criterion) or
t reaches T_MAX, then restarts at size: a
checkpoint, and where h5py is installed a CGNS file, are written under
``--out-dir`` (required; a 128^3 CGNS file is ~130 MB), loaded into
fresh solvers and advanced 50 steps; their C_D must stay within 5e-3.
The literature's C_D at Re 100 is 1.08-1.10 (Johnson & Patel 1999); the
reference's TPU record at L 4, retract 0.5 is 1.1313 (SPHERE128.json).

    python -m fluca_tpu_torch.examples.sphere_drag --out-dir DIR [--L 4]
        [--retract 0.5] [--N 128] [--device cuda] [--out PATH]

Prints one JSON line; exits 1 when C_D leaves the band 1.0-1.15 or a
restart drifts.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from fluca_tpu_torch.models.sphere import drag_coefficient, setup_sphere_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig

D, U_IN, DT = 0.5, 1.0, 8e-3
N = 128  # cells per axis: BASELINE #4's grid, the default of --N
CHUNK = 250  # steps between C_D readings
T_MAX = 30.0
BAND = (1.0, 1.15)
RESTART_DRIFT = 5e-3


def setup(L, retract, device, n=None):
    n = N if n is None else n
    ns, ibm = setup_sphere_3d(N=(n,) * 3, domain=(L, L, L),
                              center=({3.0: 1.0, 4.0: 1.5}.get(L, 0.375 * L), L / 2, L / 2),
                              diameter=D, Re=100.0, U_in=U_IN, dt=DT, max_steps=10**9,
                              dtype=torch.float32, retract=retract, device=device)
    ns.impl.cfg = CNLinearConfig.production(outer=3, mom=8, schur=8)
    return ns, ibm


def restart_cd(load, args):
    """C_D after 50 steps of a fresh solver restored by ``load(ns)``."""
    ns, ibm = setup(args.L, args.retract, args.device, args.N)
    load(ns)
    ns.advance(50)
    return drag_coefficient(ns, ibm, U_IN, D)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--L", type=float, default=4.0)
    ap.add_argument("--retract", type=float, default=0.5)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--N", type=int, default=None, help=f"cells per axis (default {N})")
    args = ap.parse_args(argv)
    if args.N is None:
        args.N = N

    ns, ibm = setup(args.L, args.retract, args.device, args.N)
    t0 = time.perf_counter()
    ns.step()
    first = time.perf_counter() - t0
    hist = []
    steps, t0 = 1, time.perf_counter()
    while ns.t < T_MAX:
        tc = time.perf_counter()
        ns.advance(CHUNK)
        steps += CHUNK
        cd = drag_coefficient(ns, ibm, U_IN, D)
        if not np.isfinite(cd):
            raise RuntimeError(f"diverged at t={ns.t}")
        hist.append((float(ns.t), cd))
        print(f"t={ns.t:6.2f} cd={cd:.4f} "
              f"({CHUNK / (time.perf_counter() - tc):.2f} steps/s)", flush=True)
        if (len(hist) >= 3 and ns.t > 12.0 and abs(hist[-1][1] - hist[-2][1]) < 3e-4
                and abs(hist[-2][1] - hist[-3][1]) < 3e-4):
            break
    wall = time.perf_counter() - t0
    cd = hist[-1][1]

    os.makedirs(args.out_dir, exist_ok=True)
    ck = os.path.join(args.out_dir, f"sphere{args.N}_checkpoint")
    save_checkpoint(ck, ns)
    cd_ck = restart_cd(lambda s: load_checkpoint(ck, s), args)
    try:
        import h5py  # noqa: F401
    except ImportError:
        cd_cgns, cgns_note = None, "h5py is not installed: no CGNS restart"
    else:
        from fluca_tpu_torch.io.cgns import CGNSWriter, load_solution_cgns

        path = os.path.join(args.out_dir, f"sphere{args.N}.cgns")
        with CGNSWriter(path, ns.mesh) as w:
            w.write_solution(ns)
        cd_cgns = restart_cd(lambda s: load_solution_cgns(path, s), args)
        cgns_note = f"{os.path.getsize(path) / 1e6:.1f} MB"

    ok_band = BAND[0] <= cd <= BAND[1]
    drifts = [abs(c - cd) for c in (cd_ck, cd_cgns) if c is not None]
    ok_restart = all(d < RESTART_DRIFT for d in drifts)
    dev = torch.device(args.device)
    emit({"config": f"sphere {args.N}^3 Re 100 (BASELINE #4)", "N": args.N, "domain_L": args.L,
          "retract": args.retract, "cells_per_diameter": D / (args.L / args.N),
          "markers": int(ibm.markers.X.shape[0]), "cd": cd, "band": BAND, "in_band": ok_band,
          "t_final": float(ns.t), "steps": steps, "first_step_s": first,
          "wall_s": wall, "steps_per_s": (steps - 1) / wall,
          "checkpoint_restart_cd": cd_ck, "cgns_restart_cd": cd_cgns, "cgns": cgns_note,
          "restart_ok": ok_restart,
          "max_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None),
          "history": hist, "reference_tpu_cd": 1.1313},
         args.device, args.out)
    return 0 if ok_band and ok_restart else 1


if __name__ == "__main__":
    raise SystemExit(main())
