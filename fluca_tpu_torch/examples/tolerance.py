"""The reference's accuracy contract on the card (counterpart of
examples/tolerance.py). The reference stops every coupled solve at KSP
rtol 1e-5 on the unpreconditioned residual (nssol.c:22-25). This script

1. runs the tolerance path (FGMRES outer, BiCGStab and CG+MG inner
   solves, each at rtol 1e-5) on the wall-clustered channel at 128^3 and
   at 512x256x256 (BASELINE #5's size), recording steps/s, outer
   iterations and the achieved relative residual of every step, and
2. maps each fixed-budget preset (production, production_fast, the bf16
   momentum preconditioner, the Richardson outer) to its effective
   per-step rtol, ksp_rnorm / ||rhs||, at both sizes,

with the rows, labels, sizes, time steps and presets of the JAX script.
Every row also records the peak device memory. The 512 FGMRES row keeps
the JAX script's restart of 4 unless ``--restart`` says otherwise: the
basis holds about 2 * restart + 1 coupled vectors of 0.94 GB each in
float32 (about 8.5 GB at 4, 58 GB at 30, before the inner solves).

    python -m fluca_tpu_torch.examples.tolerance --out PATH [LABELS]
        [--restart 4] [--device cuda]

LABELS (comma-separated substrings) runs only the matching rows. Each
row prints one JSON line as it ends; the whole record, rows so far,
is rewritten to PATH after each row (never the repo's TOLERANCE.json,
the reference's TPU record). steps/s includes a host read per step (the
diagnostics) and is not the bench's steps/s.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path

import torch

from fluca_tpu_torch.bench import device_info
from fluca_tpu_torch.examples._common import parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device

REFERENCE_RECORD = Path(__file__).resolve().parents[2] / "TOLERANCE.json"
N128 = (128, 128, 128)
N512 = (512, 256, 256)
# the bench's dt at 128^3 is a convective CFL of ~5.8 (centreline u ~ 90,
# h_x = 4/128), where the fixed budgets under-resolve; 3e-4 (CFL ~ 0.86)
# is a production step; 5e-5 at 512 is bench.py channel512's (CFL ~ 0.6)
DT128_CFL6 = 2e-3
DT128 = 3e-4
DT512 = 5e-5
NOTE = ("achieved_rtol = ksp_rnorm / ||rhs|| per step (the reference's "
        "unpreconditioned relative residual, nssol.c:24-25). Tolerance rows "
        "run the FGMRES path with rtol 1e-5; production rows are "
        "fixed-budget presets whose effective rtol is measured. compile_s is "
        "the first step's wall seconds (the kernels' build on first use); "
        "steps/s includes a host read per step (the diagnostics).")


def _mean_abs_u(ns) -> float:
    return float(ns.state["v"][0].abs().mean())


def run_config(N, cfg, label, nsteps=10, dt=None, *, device="cuda"):
    """One row: the channel at ``N`` (stretch 2.0, float32) under ``cfg``
    with ||rhs|| in the diagnostics, a first step then ``nsteps`` steps;
    the row's record (the JAX script's keys, the peak device memory and
    the device). A failure (out of memory, a solver error) is recorded
    in the row's "error" and the script goes on to the next row."""
    cfg.diag_rhs_norm = True
    rec = {"label": label, "N": list(N), "dt": dt}
    cuda = torch.device(device).type == "cuda"
    ns = None
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ns = setup_channel_3d(N=N, dt=dt, max_steps=10**9, stretch_y=2.0,
                              dtype=torch.float32, device=device)
        ns.impl.cfg = cfg
        u0 = _mean_abs_u(ns)
        t0 = time.perf_counter()
        ns.step()
        rec["compile_s"] = round(time.perf_counter() - t0, 1)
        rels, its = [], []
        t0 = time.perf_counter()
        for _ in range(nsteps):
            ns.step()
            d = ns.last_diag
            rels.append(float(d["ksp_rnorm"]) / max(float(d["rhs_norm"]), 1e-30))
            its.append(int(d["ksp_iters"]))
        wall = time.perf_counter() - t0
        u1 = _mean_abs_u(ns)
        rec.update({
            "steps_per_sec": round(nsteps / wall, 3),
            "outer_iters": its,
            "achieved_rtol_per_step": [f"{r:.2e}" for r in rels],
            "achieved_rtol_last": float(f"{rels[-1]:.3e}"),
            "ksp_rnorm_last": round(float(ns.last_diag["ksp_rnorm"]), 3),
            "rhs_norm_last": round(float(ns.last_diag["rhs_norm"]), 3),
            "retention": round(u1 / u0, 4),
        })
    except Exception as e:  # noqa: BLE001 -- a row's failure is its result
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        if cuda:
            rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        del ns
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return rec


def rows(restart=4):
    """(N, cfg, label, keyword arguments) of every row, in the JAX
    script's order."""
    def bf16mom(c):
        c.precond_dtype = "bfloat16"
        c.precond_scope = "mom"
        return c

    def richardson(outer, mom, schur):
        c = CNLinearConfig.production(outer, mom, schur)
        c.mom_solver = "jacobi"
        c.outer_type = "richardson"
        return bf16mom(c)

    tol512 = CNLinearConfig()
    tol512.restart = restart
    tol512.maxiter = 12
    jac = CNLinearConfig.production(2, 6, 8)
    jac.mom_solver = "jacobi"
    return [
        (N128, CNLinearConfig(), "tol1e-5_fgmres_128_cfl5.8", {"dt": DT128_CFL6}),
        (N128, CNLinearConfig.production(), "production_o3m8s6_128_cfl5.8",
         {"dt": DT128_CFL6}),
        (N128, bf16mom(CNLinearConfig.production()), "production_o3m8s6_bf16mom_128_cfl5.8",
         {"dt": DT128_CFL6}),
        (N128, CNLinearConfig.production_fast(), "production_fast_gcr_128_cfl5.8",
         {"dt": DT128_CFL6}),
        (N128, CNLinearConfig(), "tol1e-5_fgmres_128_cfl0.86", {"dt": DT128}),
        (N128, CNLinearConfig.production(), "production_o3m8s6_128_cfl0.86", {"dt": DT128}),
        (N128, bf16mom(CNLinearConfig.production()), "production_o3m8s6_bf16mom_128_cfl0.86",
         {"dt": DT128}),
        (N512, tol512, f"tol1e-5_fgmres_r{restart}_512", {"nsteps": 3, "dt": DT512}),
        (N512, CNLinearConfig.production(2, 8, 6), "production_o2m8s6_f32_512", {"dt": DT512}),
        (N512, bf16mom(CNLinearConfig.production(2, 8, 6)), "production_o2m8s6_bf16mom_512",
         {"dt": DT512}),
        (N512, bf16mom(CNLinearConfig.production(3, 8, 6)), "production_o3m8s6_bf16mom_512",
         {"dt": DT512}),
        (N512, richardson(8, 6, 8), "tolcontract_richardson_o8jac6s8_bf16mom_512",
         {"dt": DT512}),
        (N512, richardson(10, 6, 8), "tolcontract_richardson_o10jac6s8_bf16mom_512",
         {"dt": DT512}),
        (N512, bf16mom(jac), "production_o2jac6s8_bf16mom_512", {"dt": DT512}),
    ]


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("labels", nargs="?", default=None,
                    help="comma-separated label substrings: run only those rows")
    ap.add_argument("--restart", type=int, default=4,
                    help="FGMRES restart of the 512x256x256 tolerance row (default 4)")
    args = ap.parse_args(argv)
    if args.out is None:
        ap.error("--out PATH is required")
    if Path(args.out).resolve() == REFERENCE_RECORD:
        ap.error(f"{REFERENCE_RECORD.name} is the reference's TPU record: write elsewhere")
    dev = check_device(args.device)
    only = args.labels.split(",") if args.labels else None
    result = {"note": NOTE, "device": device_info(dev), "rows": []}
    for N, cfg, label, kw in rows(args.restart):
        if only and not any(o in label for o in only):
            continue
        result["rows"].append(run_config(N, cfg, label, device=args.device, **kw))
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if all("error" not in r for r in result["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
