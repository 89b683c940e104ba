"""Backward-facing step, expansion ratio 2 (counterpart of
examples/backward_step.py): runs to steady state and reports the
lower-wall reattachment length x_r/S against the literature (Armaly et
al. 1983 experiment ~3.0 at Re 100; 2-D computations 2.8-3.1).

    python -m fluca_tpu_torch.examples.backward_step [--re 100] [--nx 512]
        [--ny 64] [--length 10] [--dt 0.01] [--tmax 80] [--device cuda]
        [--out PATH]

Prints one JSON line; exits 1 when x_r/S leaves the literature band of
that Re or the run diverges.
"""

from __future__ import annotations

import time

import numpy as np

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.bfs import reattachment_length, setup_bfs_2d

# 2-D literature bands for ER=2 (Armaly et al. 1983 exp + 2-D
# computations incl. Gartling 1990 at Re=800, x_r = 12.2 S); above
# Re~400 the experiment exceeds 2-D values (three-dimensionality), so the
# bands are the 2-D computational ones
LITERATURE = {
    100.0: (2.4, 3.6, "exp ~3.0, 2-D 2.8-3.2"),
    200.0: (4.5, 5.9, "exp ~5.2, 2-D 4.9-5.4"),
    400.0: (7.6, 9.3, "2-D 8.2-8.7 (exp ~8.9)"),
    600.0: (9.5, 11.8, "2-D 10.3-11.0"),
    800.0: (11.0, 13.4, "Gartling 12.2 (2-D)"),
}
S = 0.5


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--length", type=float, default=10.0)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--tmax", type=float, default=80.0)
    args = ap.parse_args(argv)
    max_steps = int(args.tmax / args.dt) + 1
    ns = setup_bfs_2d(N=(args.nx, args.ny), L=args.length, Re=args.re, dt=args.dt,
                      max_steps=max_steps, device=args.device)
    chunk = max(1, min(200, max_steps - 2))
    ns.step()
    u_prev = ns.state["v"][0].cpu().numpy()
    t0 = time.perf_counter()
    while ns.step_index < max_steps - chunk:
        ns.advance(chunk)
        u = ns.state["v"][0].cpu().numpy()
        if not np.all(np.isfinite(u)):
            emit({"re": args.re, "diverged_at_t": float(ns.t)}, args.device, args.out)
            return 1
        du = float(np.max(np.abs(u - u_prev))) / (chunk * args.dt)
        print(f"t={ns.t:7.2f}  max|du/dt|={du:.3e}  "
              f"x_r/S={reattachment_length(ns) / S:.3f}", flush=True)
        u_prev = u
        if du < 1e-6:
            break
    wall = time.perf_counter() - t0
    band = LITERATURE.get(args.re)
    xr = reattachment_length(ns) / S
    emit({"re": args.re, "grid": [args.nx, args.ny], "x_r_over_S": xr,
          "literature": band[2] if band else "n/a for this Re",
          "t_final": float(ns.t), "wall_s": wall}, args.device, args.out)
    return 1 if band and not band[0] <= xr <= band[1] else 0


if __name__ == "__main__":
    raise SystemExit(main())
