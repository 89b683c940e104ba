"""fluca_tpu's accuracy pin of the bf16 preconditioner
(examples/tune_budget_tpu.py; chip_smoke.py phase_budget_bf16) on the
port: the 2-D Re-100 cavity at 128^2, dt 0.005, 50 float32 steps of
production(3, 8, 6) with the bf16 preconditioner on both inner solves,
and its max |deviation| over u, v and p from the converged FGMRES rtol
1e-5 solve of the same steps (in U_lid).

    python -m fluca_tpu_torch.examples.pin128 [--steps 50] [--repeats 1]
        [--save-steps PATH] [--compare-steps PATH] [--outer] [--device cuda] [--out PATH]

``--repeats`` runs the bf16 solve that many times in the process (the
pin's spread). ``--save-steps`` writes the bf16 run's u, v and p after
every step; ``--compare-steps`` runs the same steps from the same initial
state and reports, per step, the max |difference| from the saved ones:
save on the card and compare on the CPU (``--device cpu``) to follow
the two apart step by step. ``--outer`` also runs the reference's
outer-budget sweep (examples/tune_budget_tpu.py:53-57): float32
production() and production(o, 8, 6) with the bf16 preconditioner (both
inner solves) at o = 3, 4, 5, each with its deviation and whether it meets
the repo's production pin, 2e-4 U_lid. Prints one JSON line.
"""

from __future__ import annotations

import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.cavity import setup_cavity_2d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device


def bf16_both() -> CNLinearConfig:
    cfg = CNLinearConfig.production(3, 8, 6)
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = "both"
    return cfg


# the production pin's bar (examples/tune_budget_tpu.py:51; tests/test_fastpath.py)
PIN_BAR = 2e-4


def outer_sweep():
    """(label, config) of the reference's outer-budget sweep
    (examples/tune_budget_tpu.py:53-57)."""
    out = [("production_o3_f32", CNLinearConfig.production())]
    for o in (3, 4, 5):
        cfg = CNLinearConfig.production(o, 8, 6)
        cfg.precond_dtype = "bfloat16"
        out.append((f"production_o{o}_bf16", cfg))
    return out


def fields(ns):
    """u, v and p on the CPU in float64."""
    return [x.detach().to("cpu", torch.float64) for x in (*ns.state["v"], ns.state["p"])]


def run(cfg, steps, device, each=None):
    """The cavity after ``steps`` steps under ``cfg``; ``each(step,
    fields)`` after every step when given."""
    ns = setup_cavity_2d(N=128, Re=100.0, dt=0.005, max_steps=10**9, dtype=torch.float32,
                         device=device)
    ns.impl.cfg = cfg
    for k in range(steps):
        ns.advance(1)
        if each is not None:
            each(k + 1, fields(ns))
    out = fields(ns)
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise RuntimeError("the pin's fields went non-finite")
    return out


def max_dev(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--save-steps", default=None)
    ap.add_argument("--compare-steps", default=None)
    ap.add_argument("--outer", action="store_true", help="also run the outer-budget sweep")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    ref = run(CNLinearConfig(), args.steps, device)
    result = {"steps": args.steps, "max_dev_bf16": []}
    saved = torch.load(args.compare_steps) if args.compare_steps else None
    for r in range(args.repeats):
        trace, diffs = [], []

        def each(step, f):
            if args.save_steps and r == 0:
                trace.append(f)
            if saved is not None and r == 0:
                diffs.append(max_dev(f, saved[step - 1]))

        result["max_dev_bf16"].append(max_dev(run(bf16_both(), args.steps, device, each), ref))
        if args.save_steps and r == 0:
            torch.save(trace, args.save_steps)
        if saved is not None and r == 0:
            result["max_abs_vs_saved_by_step"] = diffs
    if args.outer:
        devs = {label: max_dev(run(cfg, args.steps, device), ref) for label, cfg in outer_sweep()}
        result["outer_sweep"] = devs
        result["outer_sweep_pass"] = {label: d < PIN_BAR for label, d in devs.items()}
    emit(result, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
