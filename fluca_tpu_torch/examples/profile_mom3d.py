"""The 3-D momentum BiCGStab iteration split into its A-applies and its
vector algebra at 128^3 (the channel, dt 2e-3, float32; counterpart of
examples/profile_mom3d.py), each timed by the slope of chained calls:

- the A-apply with its face factors rebuilt in each call (the fused
  momentum kernel, csrc/momentum3d.cu, on the factors of the first step);
- the traffic it must move: a plain sum that reads v and the 15
  cell-shaped face factors (U0's low and high, v0f's low) and writes 3
  fields, as the reference's "speed of light" (18 fields in, 3 out);
  beside it the kernel's bound, the bytes of its inputs (v and the 12
  face arrays) and outputs over the card's 3.35 TB/s;
- an 8-iteration Jacobi-preconditioned BiCGStab solve, per iteration,
  and what of it is not its two A-applies.

    python -m fluca_tpu_torch.examples.profile_mom3d [--N 128] [--device cuda] [--out PATH]

Prints one JSON line (ms).
"""

from __future__ import annotations

import torch

from fluca_tpu_torch.bench import PEAK_BYTES_PER_S, slope_time_per_iter
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.solvers.krylov import bicgstab

MOM_ITERS = 8
# chained calls of the two slope runs: of the applies, of the solve
# (the reference's, examples/profile_mom3d.py:15, :105)
APPLY_ITERS = (20, 150)
SOLVE_ITERS = (3, 20)


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--N", type=int, default=128)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    N = args.N
    ns = setup_channel_3d(N=(N, N, N), dt=2e-3, max_steps=10, dtype=torch.float32,
                          device=device)
    ops, state = ns.impl.ops, ns.state
    U0 = state["U"]
    Bv0, bcB = ops.apply_B(state["v"]), ops.bc_B(0.0)
    v0f = tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(3)) for d in range(3))
    v = state["v"]

    def apply_once(x):
        return ops.apply_A_coeffs(x, ops.build_momentum_factors_3d(U0, v0f))

    t_apply = slope_time_per_iter(apply_once, v, *APPLY_ITERS)
    f = ops.build_momentum_factors_3d(U0, v0f)
    kernel_bytes = _bytes(*v, *f.U0, *(F for row in f.v0f for F in row), *v)

    factors = []
    for d in range(3):
        factors += list(ops._face_factors(U0[d], d))
        factors += [ops._face_factors(v0f[d][c], d)[0] for c in range(3)]

    def sol(x):
        s = factors[0]
        for F in factors[1:]:
            s = s + F
        return tuple(x[c] + s for c in range(3))

    t_sol = slope_time_per_iter(sol, v, *APPLY_ITERS)

    diagA = ops.diag_A(U0, v0f)

    def solve(x):
        coeffs = ops.build_momentum_factors_3d(U0, v0f)
        inv_diag = tuple(1.0 / d for d in diagA)
        return bicgstab(lambda y: ops.apply_A_coeffs(y, coeffs), x, maxiter=MOM_ITERS,
                        M=lambda r: tuple(inv_diag[c] * r[c] for c in range(3))).x

    t_solve = slope_time_per_iter(solve, v, *SOLVE_ITERS)
    per_iter = t_solve / MOM_ITERS
    emit({"grid": [N] * 3, "a_apply_ms": t_apply * 1e3,
          "speed_of_light_ms": t_sol * 1e3, "speed_of_light_fields": [3 + len(factors), 3],
          "a_apply_bound_ms": kernel_bytes / PEAK_BYTES_PER_S * 1e3,
          "a_apply_bytes": kernel_bytes,
          f"bicgstab{MOM_ITERS}_ms": t_solve * 1e3, "per_iter_ms": per_iter * 1e3,
          "vec_op_share_ms_per_iter": (per_iter - 2 * t_apply) * 1e3}, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
