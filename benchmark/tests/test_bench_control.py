"""The lower-precision control fails the comparison: at a size a test
run holds, in float32 on the CPU, each cell's control (the program with
its bf16 path switched on, or the reference in bf16 put in the
program's place) reads above three times the largest reading of the
program over the same seeds on at least one compared number, so that a
limit between the two exists. The chip's readings at the cells' own
sizes, from ``benchmark/limits.py``, set the cells' limits (PERF.md),
and ``limits.py --judge`` holds them to those limits: the judgement is
tested here on planted records."""

import pytest
import torch
from conftest import LIMITS, SEED, B, tiny_cell

from benchmark import harness
from benchmark.limits import judge, readings

CASES = {
    "channel512.shipped": ("channel", "shipped"),
    "sphere192.wake": ("sphere", "wake"),
    "channel512.rtol": ("channel", "rtol"),
}


@pytest.mark.parametrize("workload", sorted(CASES))
def test_the_control_reads_apart_from_the_program(monkeypatch, workload):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    kind, traffic = CASES[workload]
    cell = tiny_cell(kind, dtype="float32")
    cell.traffic = harness.load_json(B / "traffic" / f"{traffic}.json")
    spec = harness.load_json(B / "cells" / f"{workload}.json")["control"]
    ref = harness.reference_step(cell, "cpu")
    seeds = [SEED + i for i in range(3)]
    post = cell.traffic["setup_steps"] + 2
    prog = list(readings(cell, seeds, "cpu", post, ref=ref))
    if "reference" in spec:
        ctl = harness.reference_step(cell, "cpu", spec["reference"])
        cont = list(readings(cell, seeds, "cpu", post, ref=ref, ctl=ctl))
    else:
        solver = dict(cell.traffic["solver"], **spec["solver"])
        cont = list(readings(cell, seeds, "cpu", post, solver=solver, ref=ref))
    apart = [name for name in LIMITS
             if min(r[name] for r in cont) > 3 * max(r[name] for r in prog)]
    assert apart, {name: (max(r[name] for r in prog), min(r[name] for r in cont))
                   for name in LIMITS}


@pytest.mark.parametrize("workload", sorted(CASES))
def test_the_judgement_uses_the_cells_limits(workload):
    cell = harness.load_cell(workload)
    lim = cell.limits["limits"]
    under = {f"{s}_{p}_gap": 0.5 * lim.get(f"{s}_{p}_gap", 1.0)
             for s in harness.STEPS for p in ("vel", "p")}
    over = dict(under, **{k: 2 * v for k, v in lim.items()})
    one = dict(under, **{next(iter(lim)): 2 * next(iter(lim.values()))})
    recs = [dict(under, kind="program", seed=1, failed=0),
            dict(one, kind="control", seed=2, failed=0)]
    rows, good = judge(cell, recs)
    assert good and [ok for _, _, ok, _ in rows] == [True, False]
    for bad in (dict(under, kind="control", seed=3, failed=0),
                dict(over, kind="program", seed=4, failed=0),
                dict(under, kind="program", seed=5, failed=1)):
        assert not judge(cell, [bad])[1]
