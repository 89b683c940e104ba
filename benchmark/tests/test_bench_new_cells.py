"""The cells channel512.f32 and cylinder4096.wake: both load with their
files, every metric on their lists has a reader that declares its entry,
the f32 traffic is the shipped budget in float32, and each cell's
control reads apart from the program at a small size on the CPU."""

import json

import pytest
import torch
from conftest import LIMITS, ROOT, SEED, B, tiny_cell
from test_bench_cylinder import tiny_cylinder

from benchmark import harness
from benchmark.limits import readings

NEW = ("channel512.f32", "cylinder4096.wake")


@pytest.mark.parametrize("workload", NEW)
def test_the_cell_loads_and_each_metric_has_a_reader(workload):
    cell = harness.load_cell(workload)
    assert cell.chips == 1 and cell.config["dtype"] == "float32"
    assert set(cell.limits["limits"]) == set(LIMITS)
    names = [m["name"] for m in cell.end_to_end]
    suffix = ".wake" if workload.endswith(".wake") else ""
    assert {f"steps_per_s{suffix}", f"step_ms_p95{suffix}", "peak_mem_gib", "setup_s"} == set(names)
    for m in cell.end_to_end:
        harness.reader_path(ROOT, "end_to_end", m["name"])
    for m in cell.per_layer:
        path = harness.reader_path(ROOT, "metrics", m["name"])
        mod = harness.load_module(path, "m")
        assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES + m["name"][len(path.stem):]) == (
            m["layer"], m["source"], m["unit"], m["moves"]), m["name"]
        assert m["moves"] in names


def test_the_new_readers_declare_their_entries():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = {m["name"]: m for m in bench["per_layer"]
           if m["name"] in ("roofline_pct.poisson2d.wake", "roofline_pct.momentum2d.wake")}
    assert len(new) == 2
    for name, m in new.items():
        path = harness.reader_path(ROOT, "metrics", name)
        assert path.name == name.removesuffix(".wake") + ".py"
        mod = harness.load_module(path, "m")
        assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES + ".wake") == (
            m["layer"], m["source"], m["unit"], m["moves"])
        assert m["workloads"] == ["cylinder4096.wake"]
    # the 3-D rooflines read nothing in 2-D: the cylinder is not on their lists
    for m in bench["per_layer"]:
        if m["name"].endswith(("3d", "3d.wake")):
            assert "cylinder4096.wake" not in m.get("workloads", ())


def test_the_f32_traffic_is_the_shipped_budget_in_float32():
    shipped = harness.load_json(B / "traffic/shipped.json")
    f32 = harness.load_json(B / "traffic/f32.json")
    want = {k: v for k, v in shipped["solver"].items() if k not in ("precond_dtype",
                                                                     "precond_scope")}
    assert f32["solver"] == want
    assert {k: f32[k] for k in ("setup_steps", "trace_steps", "gates")} == {
        k: shipped[k] for k in ("setup_steps", "trace_steps", "gates")}
    cfg = harness.program_solver(f32["solver"])
    assert cfg.precond_dtype is None and cfg.mom_solver == "jacobi"


@pytest.mark.parametrize("workload", NEW)
def test_the_control_reads_apart_from_the_program(monkeypatch, workload):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    w = harness.load_cell(workload)
    cell = tiny_cylinder("float32") if workload.startswith("cylinder") else tiny_cell(
        "channel", dtype="float32")
    cell.traffic = w.traffic
    ref = harness.reference_step(cell, "cpu")
    seeds = [SEED + i for i in range(3)]
    post = cell.traffic["setup_steps"] + 2
    prog = list(readings(cell, seeds, "cpu", post, ref=ref))
    solver = dict(cell.traffic["solver"], **w.limits["control"]["solver"])
    cont = list(readings(cell, seeds, "cpu", post, solver=solver, ref=ref))
    apart = [name for name in LIMITS
             if min(r[name] for r in cont) > 3 * max(r[name] for r in prog)]
    assert apart, {name: (max(r[name] for r in prog), min(r[name] for r in cont))
                   for name in LIMITS}
