"""The budget diagnosis of the 128^3 wall-clustered channel's fluctuation
collapse (counterpart of examples/diag_turb128.py). On the TPU the f32
production budgets (o3/m8/s6) took E_turb from 38 to 4e-7 within 500
steps: too fast for viscous decay of large-scale rolls by three orders
of magnitude, so either the fixed budgets under-resolve at this
stiffness (first cell y+ ~ 0.2, cell aspect ~ 28) or something is
structurally wrong at this configuration.

Short probes from the rolls (dt 5e-4, float32), each printing E_turb,
u_tau and the residual along the run:
  production      production() o3/m8/s6, 400 steps (the collapsing one)
  big-budgets     production(5, 12, 10), 400 steps (the budget hypothesis)
  tolerance-1e-5  FGMRES rtol 1e-5, 100 steps (the ground truth)

    python -m fluca_tpu_torch.examples.diag_turb128 [production|big|tol]
        [--device cuda] [--out PATH]

A label substring runs the matching probes only. Prints the JAX script's
lines, then one JSON line of every probe's readings (also to PATH).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig

N = (128, 128, 128)
DT = 5e-4


def E_and_utau(ns):
    """The fluctuation kinetic energy about the streamwise mean profile
    (u' about the xz-mean, v and w whole) and u_tau from the wall
    gradient, on the host in float64 as the JAX script's."""
    v = [x.detach().to("cpu", torch.float64).numpy() for x in ns.state["v"]]
    cy = np.asarray(ns.mesh.centers(1))
    Umean = v[0].mean(axis=(0, 2))
    up = v[0] - Umean[None, :, None]
    E = 0.5 * float((up**2 + v[1] ** 2 + v[2] ** 2).mean())
    nu = ns.mu / ns.rho
    dudy = 0.5 * (Umean[0] / cy[0] + Umean[-1] / (2.0 - cy[-1]))
    return E, float(np.sqrt(max(nu * dudy, 0.0)))


def cases():
    """(label, config, steps) of the three probes."""
    return [("production", CNLinearConfig.production(), 400),
            ("big-budgets", CNLinearConfig.production(5, 12, 10), 400),
            ("tolerance-1e-5", CNLinearConfig(), 100)]


def run(label, cfg, nsteps=400, chunk=100, *, device="cuda", shape=N):
    """One probe: the first step's residual, then E_turb, u_tau and the
    worst residual of each chunk of ``chunk`` steps; returns its readings."""
    cfg.diag_rhs_norm = True
    ns = setup_channel_3d(N=shape, dt=DT, max_steps=10**9, stretch_y=2.0, perturb=0.2,
                          perturb_mode="rolls", dtype=torch.float32, device=device)
    ns.impl.cfg = cfg
    E0, ut0 = E_and_utau(ns)
    print(f"--- {label}: E0={E0:.3f} u_tau0={ut0:.3f}", flush=True)
    ns.step()
    d = ns.last_diag
    rel = float(d["ksp_rnorm"]) / float(d["rhs_norm"])
    print(f"  step1 rnorm={float(d['ksp_rnorm']):.4g} rel={rel:.3e}", flush=True)
    rec = {"label": label, "E0": E0, "u_tau0": ut0, "step1_rnorm": float(d["ksp_rnorm"]),
           "step1_rel": rel, "chunks": []}
    for _ in range(nsteps // chunk):
        t0 = time.perf_counter()
        ns.advance(chunk)
        E, ut = E_and_utau(ns)
        d = ns.last_diag
        rate = chunk / (time.perf_counter() - t0)
        print(f"  t={ns.t:7.4f} E={E:10.4e} u_tau={ut:.4f} rnorm={float(d['ksp_rnorm']):.4g} "
              f"({rate:.1f} steps/s)", flush=True)
        rec["chunks"].append({"t": round(ns.t, 4), "E": E, "u_tau": ut,
                              "rnorm": float(d["ksp_rnorm"]), "steps_per_sec": rate})
        if not np.isfinite(E):
            break
    del ns
    gc.collect()
    return rec


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("only", nargs="?", default=None, help="run the probes whose label "
                    "holds this substring")
    args = ap.parse_args(argv)
    out = [run(label, cfg, nsteps, device=args.device) for label, cfg, nsteps in cases()
           if not args.only or args.only in label]
    emit({"probes": out}, args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
