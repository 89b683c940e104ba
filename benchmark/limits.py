"""The readings that a cell's limits are set from: the program's gaps to
the plain reference on many seeds, and the control's; and the judgement
of such readings by the cell's limits.

    python3 benchmark/limits.py --workload <cell> --post-after K [--seeds 12]
        [--control-seeds 3] [--first-seed N] [--also K1,K2 --also-seeds 2]
        [--out PATH]
    python3 benchmark/limits.py --workload <cell> --judge PATH

The cell file's ``control`` gives either ``solver`` fields (a lower
precision of the program's own, switched on) or ``reference``, a dtype
in which the reference is put in the program's place. Each seed runs
the cell's set-up steps as the benchmark's runs do and goes on to ``K``
steps in all, as far as a run's window reaches; the reference then
follows the first step from the seed's fields, the second from the
program's state after the first, and the step after the ``K``-th from
the program's state there ("post"). ``--also`` reads "post" after those
step counts too, on the first ``--also-seeds`` seeds: whether the gap
depends on how far a run got. Every compared step also reads the gap of
its input itself (a step that returned its state unchanged). One JSON
line per seed (``kind`` "program" or "control") on standard output and
to ``--out``; runs on the first GPU, one process, one program object per
solver.

``--judge`` holds each line of such a file to the cell's limits, as a
run's checks do, and exits 1 where a control line passes them all or a
program line fails one.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import compare, harness  # noqa: E402


def control_step(ctl, state, t, first):
    """The control reference's step from a host state, as a host state."""
    x = compare.to_device(state, ctl.dtype, ctl.device)
    return compare.to_host(ctl.step(x, t, first)[0])


def readings(cell, seeds, device, post_after, solver=None, ref=None, ctl=None, also=(),
             also_seeds=0):
    """One record per seed; ``ctl``: a reference in a lower precision put
    in the program's place for the compared steps (from the same inputs
    as the program's)."""
    import torch

    prog = harness.Program(cell, seeds[0], device, solver=solver)
    ns = prog.ns
    setup = cell.traffic["setup_steps"]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        prog.restart(seed)
        u0 = harness.mean_abs_u(ns.state)
        posts = sorted({max(post_after, setup), *(also if i < also_seeds else ())})
        failed, snaps, rnorm, iters, step_ms, pairs = 0, [], [], [], [], {}
        for k in range(posts[-1] + 1):
            if k in posts:
                x, t = compare.to_host(ns.state), ns.t
            ts = time.perf_counter()
            ok = prog.step()
            step_ms.append(round((time.perf_counter() - ts) * 1e3, 1))
            failed += (not ok) and k < post_after
            rnorm.append(float(ns.last_diag["ksp_rnorm"]))
            iters.append(int(ns.last_diag["ksp_iters"]))
            if k < 2:
                snaps.append((compare.to_host(ns.state), ns.t))
            if k in posts:
                pairs[k] = (x, t, False, compare.to_host(ns.state))
            if k == setup - 1:
                retention = harness.mean_abs_u(ns.state) / u0
        (s1, t1), (s2, _) = snaps
        steps = {"start": (None, 0.0, True, s1), "step": (s1, t1, False, s2),
                 **{f"post@{k}": pair for k, pair in pairs.items()}}
        if ctl is not None:
            for name, (x, t, first, _) in list(steps.items()):
                if x is None:
                    x = compare.to_host(cell.flow.initial_fields(cell.config, seed, device))
                steps[name] = (x, t, first, control_step(ctl, x, t, first))
        t_ref = time.perf_counter()
        gaps = harness.reference_gaps(cell, seed, steps, device, ref=ref, unchanged=True)
        gaps["post"] = gaps[f"post@{max(post_after, setup)}"]
        rec = {"seed": seed, "failed": failed, "retention": retention,
               "rnorm_max": max(rnorm[:post_after]), "post_after": max(post_after, setup)}
        for name in harness.STEPS:
            for part in ("vel", "p"):
                rec[f"{name}_{part}_gap"] = gaps[name][part]
                rec[f"{name}_{part}_unchanged"] = gaps[name]["unchanged"][part]
        rec["posts"] = {name: {"vel": g["vel"], "p": g["p"]} for name, g in gaps.items()
                        if name.startswith("post@")}
        rec["leaves"] = {name: g["leaves"] for name, g in gaps.items()}
        rec.update(iters=iters, step_ms=step_ms, program_s=t_ref - t0,
                   reference_s=time.perf_counter() - t_ref)
        yield rec
    prog.close()
    del prog, ns
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(cell, records) -> tuple:
    """([(kind, seed, passes, failing checks)], whether every program
    record passes and every control record fails): each record held to
    the cell's limits and to no failed step, as a run's checks hold it."""
    out, good = [], True
    for r in records:
        gaps = {name: {"vel": r[f"{name}_vel_gap"], "p": r[f"{name}_p_gap"]}
                for name in harness.STEPS}
        checks = {"failed_steps": harness.check(r["failed"], 0, "<="),
                  **harness.gap_checks(gaps, cell.limits["limits"])}
        bad = sorted(k for k, c in checks.items() if not c["ok"])
        out.append((r["kind"], r["seed"], not bad, bad))
        good &= (not bad) if r["kind"] == "program" else bool(bad)
    return out, good


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--post-after", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--also", default="")
    ap.add_argument("--also-seeds", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--judge", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if args.judge:
        with open(args.judge) as f:
            recs = [r for r in map(json.loads, f) if r.get("workload") == cell.name]
        rows, good = judge(cell, recs)
        for kind, seed, ok, bad in rows:
            print(f"{cell.name} {kind} {seed}: {'passes' if ok else 'fails ' + ','.join(bad)}")
        return 0 if good and rows else 1

    import torch

    if not torch.cuda.is_available():
        print("limits: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ref = harness.reference_step(cell, device)
    spec = cell.limits["control"]
    control = dict(cell.traffic["solver"], **spec.get("solver", {}))
    ctl = (harness.reference_step(cell, device, spec["reference"]) if "reference" in spec
           else None)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    cseeds = [args.first_seed + 104729 + 7919 * i for i in range(args.control_seeds)]
    also = [int(k) for k in args.also.split(",") if k]
    out = open(args.out, "a") if args.out else None
    try:
        for kind, solver, ss in (("program", None, seeds), ("control", control, cseeds)):
            for rec in readings(cell, ss, device, args.post_after, solver=solver, ref=ref,
                                ctl=ctl if kind == "control" else None, also=also,
                                also_seeds=args.also_seeds if kind == "program" else 0):
                line = json.dumps({"workload": cell.name, "kind": kind, **rec})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
