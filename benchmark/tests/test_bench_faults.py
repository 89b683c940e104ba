"""The harness's comparison catches a broken step: the rest of a run
driven on the CPU (no look for a card) with the timed path broken under
it, and ``correct`` read from the result line: a step that returns its
state unchanged, a velocity altered by 1 % where it is produced, and
either fault only from the first step after the set-up on (as a program
that changes its path once warm would), which only the step after the
window can catch. The limits are the cells' own."""

import time

import pytest
from conftest import B, SEED, tiny_cell

from benchmark.harness import load_json, result_line, run_cell

# each cell's flow and traffic
CELLS = {"channel512.shipped": ("channel", "shipped"), "sphere192.wake": ("sphere", "wake"),
         "channel512.rtol": ("channel", "rtol")}


def run_broken(monkeypatch, workload, fault):
    from fluca_tpu_torch.ns.cnlinear import CNLinearSolver

    orig = CNLinearSolver.step

    late = fault is not None and fault.startswith("late ")
    kind = fault.removeprefix("late ") if fault else None
    setup = load_json(B / "traffic" / f"{CELLS[workload][1]}.json")["setup_steps"]

    def broken(self, state, t, step_index):
        new, diag = orig(self, state, t, step_index)
        if late and step_index < setup:
            return new, diag
        if kind == "unchanged":
            return state, diag
        if kind == "altered":
            v = new["v"]
            new = dict(new, v=(v[0] * 1.01, v[1], v[2]))
        return new, diag

    if fault is not None:
        monkeypatch.setattr(CNLinearSolver, "step", broken)
    flow, traffic = CELLS[workload]
    cell = tiny_cell(flow, limits=load_json(B / "cells" / f"{workload}.json")["limits"])
    cell.traffic = load_json(B / "traffic" / f"{traffic}.json")
    run = run_cell(cell, SEED, 0.2, False, time.perf_counter(), device="cpu")
    return result_line(run, False)


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("fault", [None, "unchanged", "altered", "late unchanged",
                                   "late altered"])
def test_a_broken_step_is_not_correct(monkeypatch, workload, fault):
    line = run_broken(monkeypatch, workload, fault)
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
    if fault is not None and fault.startswith("late "):
        bad = {k for k, c in line["checks"].items()
               if not (c["value"] <= c["limit"] if c["op"] == "<=" else c["value"] >= c["limit"])}
        assert bad and all(k.startswith("post_") for k in bad), line["checks"]
