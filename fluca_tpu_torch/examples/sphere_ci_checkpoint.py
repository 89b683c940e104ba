"""Generate a CI sphere checkpoint like tests/data/sphere_steady_t25
(counterpart of examples/sphere_ci_checkpoint.py): the coarse 48x32x32
analogue of the 128^3 run of sphere_drag.py (8 cells per diameter, D 0.5
at (1, 1, 1) in 3 x 2 x 2, dt 0.02, production(3, 8, 8), float64 as the
reference's), from uniform flow to t = T_END (25), printing C_D every
125 steps.

    python -m fluca_tpu_torch.examples.sphere_ci_checkpoint --out-dir DIR
        [--device cuda] [--out PATH]

The checkpoint goes to ``--out-dir`` (required; the committed one under
tests/data is read, never rewritten). Prints one JSON line.
"""

from __future__ import annotations

import os
import time

import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.io.checkpoint import save_checkpoint
from fluca_tpu_torch.models.sphere import drag_coefficient, setup_sphere_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig

D = 0.5
T_END = 25.0
COMMITTED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data")


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    if os.path.realpath(args.out_dir).startswith(os.path.realpath(COMMITTED)):
        raise SystemExit("refusing to write under tests/data: the committed "
                         "checkpoints are read, never rewritten")
    ns, ibm = setup_sphere_3d(N=(48, 32, 32), domain=(3.0, 2.0, 2.0), center=(1.0, 1.0, 1.0),
                              diameter=D, Re=100.0, dt=0.02, max_steps=10**9,
                              dtype=torch.float64, device=args.device)
    ns.impl.cfg = CNLinearConfig.production(outer=3, mom=8, schur=8)
    ns.step()
    t0 = time.perf_counter()
    while ns.t < T_END:
        ns.advance(125)
        print(f"t={ns.t:6.2f} cd={drag_coefficient(ns, ibm, 1.0, D):.4f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    save_checkpoint(args.out_dir, ns)
    emit({"checkpoint": args.out_dir, "t": float(ns.t), "step": ns.step_index,
          "cd": drag_coefficient(ns, ibm, 1.0, D), "wall_s": time.perf_counter() - t0},
         args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
