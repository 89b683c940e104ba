"""Phase by phase slope timing of the production step at the BASELINE #5
configuration (counterpart of the repo's ``examples/profile512.py``):
the wall-clustered channel (stretch_y 2.0, dt 5e-5, float32) with
production(3, 8, 6) and the bf16 preconditioner on the momentum solve.

Phases (ms per application, each chained on its own output):
  A_apply_f32 / A_apply_bf16   the momentum A-apply on the step's factors;
  coupled_apply                the outer operator (A-apply and chain);
  poisson_apply_lvl0           the 3-D Poisson apply on level 0;
  vcycle_full                  one multigrid V-cycle;
  dot+axpy_coupled             a tree dot and axpy over the coupled vector;
  mom_solve_*                  the momentum solve, 8 iterations of BiCGStab,
                               Jacobi or GCR, in bf16 and f32;
  schur_solve_cg6_f32          the Schur solve (CG + V-cycle, 6);
  abf_apply_bf16mom            one ABF preconditioner application;
  prep(B,diagA,Acoeffs,rhs)    the step's set-up before the outer solve;
  FULL_o3m8s6_bf16mom          the whole step;
then the SpMV gap rows: the copy at 8 and 4 rows per block, the copy with
two in-plane neighbour reads at 8 and 4 (``ops/probes.py``), and the
Poisson apply, each also as a rate (one read and one write of the field).

Every phase runs in one process and eagerly: the reference's phase
filter and its jit-argument tables were for the TPU's memory and its
remote compiler. The grid is an argument (default 512x256x256).

    python -m fluca_tpu_torch.examples.profile512 [--grid 512x256x256]
        [--device cuda] [--out PATH]
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fluca_tpu_torch.bench import slope_time_per_iter
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil, probes
from fluca_tpu_torch.solvers.krylov import tree_axpy, tree_dot, tree_map

F32, BF16 = torch.float32, torch.bfloat16
GAP_ROWS = ("copy_tm8", "copy_tm4", "copy+2rolls_tm8", "copy+2rolls_tm4", "spmv_lvl0")
KERNELS = (*cuda_stencil.KERNELS, *probes.KERNELS)


def build(N=(512, 256, 256), device="cuda"):
    """The channel of profile512.py:74-85 on ``device``."""
    ns = setup_channel_3d(N=N, dt=5e-5, max_steps=10**9, stretch_y=2.0, dtype=F32,
                          device=device)
    cfg = CNLinearConfig.production(3, 8, 6)
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = "mom"
    ns.impl.cfg = cfg
    return ns


def step_v0f(ops, state, t):
    """v0f = B v0 + bcB(t), as the step forms it."""
    Bv0, bcB = ops.apply_B(state["v"]), ops.bc_B(t)
    return tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(ops.dim)) for d in range(ops.dim))


def profile(ns) -> dict:
    """The phases of the solver of ``ns`` at its current state."""
    impl, ops, mg = ns.impl, ns.impl.ops, ns.impl.mg
    device = impl.device
    before = cuda_stencil.launch_counts(KERNELS)
    state, t = ns.state, 0.0
    U0 = state["U"]
    v0f = step_v0f(ops, state, t)
    diagA = ops.diag_A(U0, v0f)
    Acoeffs = ops.build_momentum_operator(U0, v0f)
    pre = impl._precond_ctx(Acoeffs, diagA, U0, v0f)
    if pre is None:
        raise ValueError("profile512 needs the reduced-precision preconditioner")
    Ac16, diagA16 = pre["Acoeffs"], pre["diagA"]
    gen = torch.Generator(device=device).manual_seed(0)

    def rand_like(a):
        return torch.randn(a.shape, generator=gen, dtype=a.dtype, device=device) * 1e-3

    rhs = tree_map(rand_like, impl._form_rhs(state, state["phalf"], t, False))
    x0 = {"v": rhs["v"], "U": rhs["U"], "p": rhs["p"]}
    field = rand_like(state["p"])
    results = {}

    def stage(name, fn, arg, lo=10, hi=40):
        results[name] = slope_time_per_iter(fn, arg, lo, hi) * 1e3
        print(f"  {name:34s}: {results[name]:9.4f} ms", flush=True)

    # ---- primitive applies -------------------------------------------
    stage("A_apply_f32", lambda v: ops.apply_A_coeffs(v, Acoeffs), rhs["v"], 20, 80)
    stage("A_apply_bf16", lambda v: ops.apply_A_coeffs(v, Ac16),
          tuple(x.to(BF16) for x in rhs["v"]), 20, 80)
    stage("coupled_apply", lambda x: impl._coupled_apply(x, Acoeffs), x0, 20, 80)
    stage("poisson_apply_lvl0", mg.apply_op, field, 20, 80)
    stage("vcycle_full", mg.precondition, field)
    stage("dot+axpy_coupled",
          lambda ab: (ab[0], tree_axpy(1e-30 * tree_dot(ab[0], ab[1]), ab[0], ab[1])),
          (x0, tree_map(lambda a: a * 0.5, x0)), 20, 80)

    # ---- solves at production budgets --------------------------------
    cfg0 = impl.cfg
    for solver, bf16 in (("bicgstab", True), ("jacobi", True), ("gcr", True),
                         ("bicgstab", False), ("jacobi", False)):
        impl.cfg = dataclasses.replace(cfg0, mom_solver=solver)
        try:
            if bf16:
                stage(f"mom_solve_{solver}8_bf16", lambda b: tuple(
                    y.to(F32) for y in impl._solve_momentum(
                        tuple(x.to(BF16) for x in b), Ac16, diagA16)), rhs["v"])
            else:
                stage(f"mom_solve_{solver}8_f32",
                      lambda b: impl._solve_momentum(b, Acoeffs, diagA), rhs["v"])
        finally:
            impl.cfg = cfg0
    stage("schur_solve_cg6_f32", impl._solve_schur, field)
    stage("abf_apply_bf16mom", lambda r: impl._abf_apply(r, Acoeffs, diagA, pre), x0)

    # ---- per-step prep -----------------------------------------------
    def prep(st):
        v0f_ = step_v0f(ops, st, t)
        ops.diag_A(st["U"], v0f_)
        ops.build_momentum_operator(st["U"], v0f_)
        r = impl._form_rhs(st, st["phalf"], t, False)
        return {"v": tuple(0.5 * x for x in r["v"]), "U": tuple(0.5 * u for u in r["U"]),
                "p": 0.5 * r["p"] + st["p"] * 0.5, "phalf": st["phalf"]}

    stage("prep(B,diagA,Acoeffs,rhs)+reads", prep, state)

    # ---- full step ---------------------------------------------------
    stage("FULL_o3m8s6_bf16mom", lambda s: impl._step_impl(s, t, False)[0], state, 4, 12)

    # ---- SpMV gap rows at this shape ---------------------------------
    for rows in (8, 4):
        stage(f"copy_tm{rows}", lambda a, rows=rows: probes.copy_scale(a, rows=rows), field,
              20, 80)
        stage(f"copy+2rolls_tm{rows}", lambda a, rows=rows: probes.copy_rolls(a, rows=rows),
              field, 20, 80)
    stage("spmv_lvl0", mg.apply_op, field, 20, 80)
    gb = 2 * math.prod(ns.mesh.cell_shape) * 4 / 1e9
    for k in GAP_ROWS:
        results[k + "_gbps"] = gb / (results[k] / 1e3)
    after = cuda_stencil.launch_counts(KERNELS)
    return {"N": list(ns.mesh.cell_shape),
            "launches": {k: n - before[k] for k, n in after.items() if n > before[k]},
            "phases_ms": results}


def run(device="cuda", N=(512, 256, 256)) -> dict:
    return profile(build(N, check_device(device)))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--grid", default="512x256x256", help="cells, e.g. 128x128x128")
    args = ap.parse_args(argv)
    N = tuple(int(n) for n in args.grid.split("x"))
    if len(N) != 3:
        raise ValueError(f"--grid takes three extents, not {args.grid!r}")
    emit(run(device=args.device, N=N), args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
