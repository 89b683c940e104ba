"""The 512x256x256 channel's fixed-budget solver combos under the
solve-quality gates (counterpart of examples/tune512.py, whose sweep chose
the solver the repo ships for BASELINE #5 from TPU timings).

Each combo (CANDIDATES, the reference's list and labels: outer GCR
iterations, the momentum solver and its budget, the CG Schur budget, bf16
on the momentum solve) runs the channel (stretch 2.0, dt 5e-5, float32)
for a first step, then 10 steps: the mean flow must keep RETENTION_MIN
(0.9) of itself, and ``ksp_rnorm`` is read. Then three timed windows of
10 steps (steps/s from the best), after which ``ksp_rnorm`` (at step 41,
the reference's "rnorm_30") must stay at or below the bench's ceiling
(PERF_CEILINGS["channel512_rnorm"], 500) and the mean flow above the
retention gate. Both gates are the reference's (tune512.py:89,
:109-110). A combo that misses a gate is marked FAIL, however fast: only
a PASS can be chosen. The line names the fastest PASS.

    python -m fluca_tpu_torch.examples.tune512 [--grid 512x256x256] [--steps 10]
        [--only LABEL,...] [--device cuda] [--out PATH]

Prints a line per combo on stderr as it ends, and one JSON line on stdout.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import torch

from fluca_tpu_torch.bench import PERF_CEILINGS, RETENTION_MIN
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.examples.tolerance import _mean_abs_u
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device

# label, outer, momentum solver, its iterations, Schur CG iterations,
# precond dtype, precond scope (examples/tune512.py:36-60)
CANDIDATES = [
    ("o3_bicgstab8_s6_bf16mom", 3, "bicgstab", 8, 6, "bfloat16", "mom"),
    ("o3_jacobi8_s6_bf16mom", 3, "jacobi", 8, 6, "bfloat16", "mom"),
    ("o3_jacobi6_s6_bf16mom", 3, "jacobi", 6, 6, "bfloat16", "mom"),
    ("o3_jacobi6_s4_bf16mom", 3, "jacobi", 6, 4, "bfloat16", "mom"),
    ("o3_gcr8_s6_bf16mom", 3, "gcr", 8, 6, "bfloat16", "mom"),
    ("o2_jacobi6_s6_bf16mom", 2, "jacobi", 6, 6, "bfloat16", "mom"),
    ("o2_jacobi8_s6_bf16mom", 2, "jacobi", 8, 6, "bfloat16", "mom"),
    ("o2_jacobi6_s8_bf16mom", 2, "jacobi", 6, 8, "bfloat16", "mom"),
    ("o3_jacobi6_s5_bf16mom", 3, "jacobi", 6, 5, "bfloat16", "mom"),
    ("o2_jacobi6_s7_bf16mom", 2, "jacobi", 6, 7, "bfloat16", "mom"),
    ("o2_jacobi5_s8_bf16mom", 2, "jacobi", 5, 8, "bfloat16", "mom"),
]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_candidate(cand, grid, steps, device) -> dict:
    """One combo's record (the reference's keys, tune512.py:63-130)."""
    label, outer, mom_solver, m, s, pdt, scope = cand
    rec = {"label": label, "outer": outer, "mom": [mom_solver, m], "schur": ["cg", s],
           "precond": [pdt, scope]}
    ns = None
    try:
        ns = setup_channel_3d(N=grid, dt=5e-5, max_steps=10**9, stretch_y=2.0,
                              dtype=torch.float32, device=device)
        cfg = CNLinearConfig.production(outer, m, s)
        cfg.mom_solver = mom_solver
        cfg.precond_dtype = pdt
        cfg.precond_scope = scope
        ns.impl.cfg = cfg
        u0 = _mean_abs_u(ns)
        t0 = time.perf_counter()
        ns.step()
        _sync(device)
        rec["compile_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        ns.advance(steps)
        u1 = _mean_abs_u(ns)
        rec["scan_compile_s"] = round(time.perf_counter() - t0, 2)
        rec["retention_10"] = round(u1 / u0, 4)
        rec["ksp_rnorm"] = round(float(ns.last_diag["ksp_rnorm"]), 2)
        if not (math.isfinite(u1) and u1 >= RETENTION_MIN * u0):
            rec["verdict"] = "FAIL: mean flow decayed"
            return rec
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            ns.advance(steps)
            float(ns.state["v"][0].sum())
            best = min(best, time.perf_counter() - t0)
        rec["steps_per_sec"] = round(steps / best, 4)
        rec["ms_per_step"] = round(best / steps * 1e3, 2)
        rec["ksp_rnorm_30"] = round(float(ns.last_diag["ksp_rnorm"]), 2)
        u2 = _mean_abs_u(ns)
        rec["retention_40"] = round(u2 / u0, 4)
        ok = (math.isfinite(u2) and u2 >= RETENTION_MIN * u0
              and rec["ksp_rnorm_30"] <= PERF_CEILINGS["channel512_rnorm"])
        rec["verdict"] = "PASS" if ok else "FAIL: quality gate"
    except Exception as e:  # noqa: BLE001 -- a combo's failure is its record
        rec["verdict"] = f"FAILED {type(e).__name__}: {e}"
    finally:
        del ns
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rec


def fastest_pass(results):
    """The label of the fastest PASS, or None."""
    ok = [r for r in results if r.get("verdict") == "PASS"]
    return max(ok, key=lambda r: r["steps_per_sec"])["label"] if ok else None


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--grid", default="512x256x256")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--only", default=None, help="comma-separated parts of labels")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    grid = tuple(int(n) for n in args.grid.split("x"))
    only = args.only.split(",") if args.only else None
    results = []
    for cand in CANDIDATES:
        if only and not any(o in cand[0] for o in only):
            continue
        rec = run_candidate(cand, grid, args.steps, device)
        results.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    emit({"grid": list(grid), "dt": 5e-5, "steps": args.steps, "retention_gate": RETENTION_MIN,
          "rnorm_max": PERF_CEILINGS["channel512_rnorm"], "results": results,
          "fastest_pass": fastest_pass(results)}, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
