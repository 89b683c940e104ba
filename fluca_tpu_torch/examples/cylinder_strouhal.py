"""Cylinder vortex shedding at Re 100 (BASELINE config #3; counterpart
of examples/cylinder_strouhal.py): 176x88 cells on 2.2 x 1.1, D 0.1 (8
cells per diameter), dt 5e-3, production(3, 8, 8), a stationary cylinder
by direct-forcing IBM.

From uniform flow with an asymmetric kick (the reference's), or from a
checkpoint (``--from-checkpoint tests/data/cylinder_saturated_t30``, the
saturated wake at t = 30), it advances in float32 to ``--t-end``
sampling C_D and C_L every CHUNK steps, and reports the Strouhal number
from the upward zero crossings of C_L over the last WINDOW time units,
the lift amplitude there, and steps/s. The reference's record (CPU
float64, t = 20..80): St 0.1641, C_L amplitude 0.224.

    python -m fluca_tpu_torch.examples.cylinder_strouhal [--t-end 80]
        [--from-checkpoint DIR] [--out-dir DIR] [--device cuda] [--out PATH]

``--out-dir`` receives the C_D/C_L series (``series.npy``: t, C_D, C_L)
and a checkpoint of the last state (``checkpoint/``). Prints one JSON
line.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from fluca_tpu_torch.models.cylinder import drag_lift_coefficients, setup_cylinder_2d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig

D, U = 0.1, 1.0
CHUNK = 5  # steps between C_D/C_L samples
WINDOW = 60.0  # time units of C_L the Strouhal number is read from


def setup(device):
    ns, ibm = setup_cylinder_2d(N=(176, 88), domain=(2.2, 1.1), center=(0.55, 0.55),
                                diameter=D, Re=100.0, dt=5e-3, max_steps=10**9,
                                dtype=torch.float32, device=device)
    ns.impl.cfg = CNLinearConfig.production(outer=3, mom=8, schur=8)
    return ns, ibm


def kick(ns):
    """The reference's asymmetric kick on v (a Gaussian bump behind the
    cylinder), which starts the shedding."""
    X, Y = np.meshgrid(ns.mesh.centers(0), ns.mesh.centers(1), indexing="ij")
    bump = 0.1 * np.exp(-((X - 0.75) ** 2 + (Y - 0.55) ** 2) / 0.01)
    v0, v1 = ns.state["v"]
    ns.set_solution(v=(v0, v1 + torch.tensor(bump, dtype=v1.dtype, device=v1.device)))


def strouhal(ts, cl):
    """(St, amplitude) from the upward zero crossings of C_L, linearly
    interpolated (tests/test_shedding.py's estimate); St is NaN when fewer
    than two crossings were seen."""
    ts, cl = np.asarray(ts), np.asarray(cl)
    s = np.sign(cl)
    idx = np.where((s[:-1] < 0) & (s[1:] > 0))[0]
    amp = 0.5 * (cl.max() - cl.min()) if len(cl) else float("nan")
    if len(idx) < 2:
        return float("nan"), float(amp)
    tc = ts[idx] + (ts[idx + 1] - ts[idx]) * (-cl[idx] / (cl[idx + 1] - cl[idx]))
    period = (tc[-1] - tc[0]) / (len(tc) - 1)
    return float(D / (U * period)), float(amp)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--t-end", type=float, default=80.0)
    ap.add_argument("--from-checkpoint", default=None)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    ns, ibm = setup(args.device)
    if args.from_checkpoint:
        load_checkpoint(args.from_checkpoint, ns)
    else:
        kick(ns)
        ns.step()
    ts, cd, cl = [], [], []
    steps0, t0 = ns.step_index, time.perf_counter()
    while ns.t < args.t_end - 1e-9:
        ns.advance(CHUNK)
        c_d, c_l = drag_lift_coefficients(ns, ibm, U_in=U, diameter=D)
        if not (np.isfinite(c_d) and np.isfinite(c_l)):
            raise RuntimeError(f"non-finite forces at t={ns.t}")
        ts.append(ns.t)
        cd.append(c_d)
        cl.append(c_l)
    wall = time.perf_counter() - t0
    ts, cd, cl = map(np.asarray, (ts, cd, cl))
    keep = ts >= ts[-1] - WINDOW
    st, amp = strouhal(ts[keep], cl[keep])
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        np.save(os.path.join(args.out_dir, "series.npy"), np.stack([ts, cd, cl]))
        save_checkpoint(os.path.join(args.out_dir, "checkpoint"), ns)
    emit({"config": "cylinder 176x88 Re 100 (BASELINE #3)", "dtype": "float32",
          "t_start": float(ts[0] - CHUNK * ns.dt), "t_end": float(ns.t),
          "steps": ns.step_index - steps0, "St": st if np.isfinite(st) else None,
          "cl_amplitude": amp,
          "cd_mean": float(cd[keep].mean()), "steps_per_s": (ns.step_index - steps0) / wall,
          "reference_cpu_f64": {"St": 0.1641, "cl_amplitude": 0.224}},
         args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
