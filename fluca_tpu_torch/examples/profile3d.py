"""The 3-D step's cost taken apart at 128^3 (the channel, dt 2e-3, float32;
counterpart of examples/profile3d.py): the production preset runs fixed
budgets (outer o, momentum m, Schur s), so timing steps/s while one budget
varies gives the marginal cost, in place in the real step, of one Schur CG
iteration (s 6 -> 2: 3 outer x 4 iterations), one momentum BiCGStab
iteration (m 8 -> 2: 3 x 6) and one outer iteration with its own ABF
application (o 3 -> 1: 2). Also the top-level Poisson apply and one
V-cycle alone, by the slope of chained calls, on the periodic-wall-
periodic Poisson hierarchy of the channel's shape. ``--fast`` runs the
same split on production_fast (damped-Jacobi momentum sweeps, V-cycle
Schur Richardson) and skips the pieces.

    python -m fluca_tpu_torch.examples.profile3d [--N 128] [--fast] [--steps 30]
        [--device cuda] [--out PATH]

Prints one JSON line: ms/step of each budget and the marginal costs.
"""

from __future__ import annotations

import torch

from fluca_tpu_torch.bench import _advance_throughput, slope_time_per_iter
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.solvers.mg import PoissonMG

# the budgets each run sets: (outer, momentum, Schur), the base first
BUDGETS = {"base": (3, 8, 6), "s2": (3, 8, 2), "m2": (3, 2, 6), "o1": (1, 8, 6)}


def time_config(N, outer, mom, schur, device, steps=30, fast=False) -> float:
    """ms per step of the channel at N^3 under the budgets: a first step
    and one window, then the best of three (profile3d.py:26-55)."""
    ns = setup_channel_3d(N=(N, N, N), dt=2e-3, max_steps=10**9, dtype=torch.float32,
                          device=device)
    preset = CNLinearConfig.production_fast if fast else CNLinearConfig.production
    ns.impl.cfg = preset(outer=outer, mom=mom, schur=schur)
    return 1e3 / _advance_throughput(ns, steps)


def time_pieces(N, device, iters=((20, 150), (5, 40))) -> dict:
    """ms of the top-level Poisson apply and of one V-cycle, chained
    (profile3d.py:58-86)."""
    per, wall = BoundaryCondition(BCType.PERIODIC), zero_velocity_bc()
    mesh = CartMesh.create((N, N, N), (True, False, True))
    mesh.set_uniform_coordinates(0, 4, 0, 2, 0, 2)
    mg = PoissonMG(mesh, [per, per, wall, wall, per, per], scale=2e-3, dtype=torch.float32,
                   device=device)
    x = torch.ones((N, N, N), dtype=torch.float32, device=device)
    return {"spmv_ms": slope_time_per_iter(mg.apply_op, x, *iters[0]) * 1e3,
            "vcycle_ms": slope_time_per_iter(mg.precondition, x, *iters[1]) * 1e3}


def marginal(ms) -> dict:
    """Each budget's marginal cost from the ms/step of BUDGETS' runs."""
    per_schur = (ms["base"] - ms["s2"]) / (3 * 4.0)
    per_mom = (ms["base"] - ms["m2"]) / (3 * 6.0)
    per_outer = (ms["base"] - ms["o1"]) / 2.0
    return {"per_schur_iter_ms": per_schur, "per_mom_iter_ms": per_mom,
            "per_outer_iter_ms": per_outer,
            "outer_fixed_part_ms": per_outer - 6 * per_schur - 8 * per_mom,
            "step_fixed_part_ms": ms["base"] - 3 * per_outer}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    result = {"grid": [args.N] * 3, "preset": "production_fast" if args.fast else "production"}
    if not args.fast:
        result.update(time_pieces(args.N, device))
    ms = {k: time_config(args.N, *b, device, steps=args.steps, fast=args.fast)
          for k, b in BUDGETS.items()}
    result["ms_per_step"] = {f"o{o}/m{m}/s{s}": ms[k] for k, (o, m, s) in BUDGETS.items()}
    result.update(marginal(ms))
    emit(result, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
