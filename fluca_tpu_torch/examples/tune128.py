"""Fixed-budget solver combos on the 128^3 float32 channel (dt 2e-3):
each combo's steps/s and how far its state lies from the production
preset's after the same steps (counterpart of examples/tune128.py), with
a reproduction run of production_fast with a Richardson outer, which
diverged in the reference's r3 bench.

Each combo (COMBOS, the reference's list and labels) runs a first step,
``--steps`` steps, then three timed windows of ``--steps`` (steps/s from
the best; 1 + 4 x 30 = 121 steps by default), and records whether u is
finite, ``ksp_rnorm``, max |u - u_production| over the cells, and the
mean |u| kept over the run (retention).

    python -m fluca_tpu_torch.examples.tune128 [--N 128] [--steps 30]
        [--device cuda] [--out PATH]

Prints a line per combo on stderr as it ends, and one JSON line on stdout.
"""

from __future__ import annotations

import gc
import json
import sys

import torch

from fluca_tpu_torch.bench import _advance_throughput
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.examples.tolerance import _mean_abs_u
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device


def bf16_production(outer, scope) -> CNLinearConfig:
    cfg = CNLinearConfig.production(outer, 8, 6)
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = scope
    return cfg


# label, config (examples/tune128.py:72-107, in its order)
COMBOS = [
    ("production(gcr+bicgstab_fixed+cg_fixed)", CNLinearConfig.production),
    ("production+bf16_precond", lambda: bf16_production(3, "both")),
    ("production+bf16_mom_only", lambda: bf16_production(3, "mom")),
    ("production_o4+bf16_precond", lambda: bf16_production(4, "both")),
    ("gcr+jacobi+vcycle", CNLinearConfig.production_fast),
    ("production_fast(richardson+jacobi+vcycle)",
     lambda: CNLinearConfig.production_fast(outer_type="richardson")),
]


def run_combo(label, make_cfg, N, steps, device):
    """(record, u after the run on the CPU or None)."""
    out = {"label": label}
    u = None
    ns = None
    try:
        ns = setup_channel_3d(N=(N, N, N), dt=2e-3, max_steps=10**9, dtype=torch.float32,
                              device=device)
        ns.impl.cfg = make_cfg()
        u0 = _mean_abs_u(ns)
        sps = _advance_throughput(ns, steps)  # examples/tune128.py:24-35
        out["steps_per_sec"] = round(sps, 3)
        out["ms_per_step"] = round(1e3 / sps, 2)
        u = ns.state["v"][0].detach().to("cpu", torch.float64)
        out["finite"] = bool(torch.isfinite(u).all())
        out["rnorm"] = float(ns.last_diag["ksp_rnorm"])
        out["retention"] = _mean_abs_u(ns) / u0
    except Exception as e:  # noqa: BLE001 -- a combo's failure is its record
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        del ns
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out, u


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    summary, ref = [], None
    for label, make_cfg in COMBOS:
        rec, u = run_combo(label, make_cfg, args.N, args.steps, device)
        if label == COMBOS[0][0]:
            ref = u
        if ref is not None and u is not None:
            rec["max_dvx_vs_production"] = float((u - ref).abs().max())
        summary.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    emit({"grid": [args.N] * 3, "dt": 2e-3, "steps": 1 + 4 * args.steps, "results": summary},
         device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
