"""The cylinder wake (``flows/cylinder.py``) against the plain reference
at a small size on the CPU, through the harness's own run: in float64 to
rounding, and in float32 inside limits that its bf16 control (bf16 on
both inner solves, the cell's ``control``) fails."""

import time

import torch
from conftest import LIMITS, SEED, B

from benchmark.harness import Cell, load_json, run_cell

# float32 limits at 128 x 64 on 8 D x 4 D: the program reads up to
# 2.6e-7 (velocity) and 2.8e-5 (pressure) over three seeds, the bf16
# control at least 4.1e-6 and 2.3e-5
F32_LIMITS = {f"{step}_{part}_gap": 1e-6 if part == "vel" else 1e-4
              for step in ("start", "step", "post") for part in ("vel", "p")}


def tiny_cylinder(dtype="float64", limits=None, solver=None) -> Cell:
    """The cylinder4096 configuration and the wake traffic on 128 x 64
    cells, 8 D x 4 D, the cylinder at (2 D, 2 D)."""
    cfg = load_json(B / "configs/cylinder4096.json")
    cfg.update(N=[128, 64], L=[8.0, 4.0], center=[2.0, 2.0], dtype=dtype)
    tr = load_json(B / "traffic/wake.json")
    if solver is not None:
        tr = dict(tr, solver=dict(tr["solver"], **solver))
    return Cell(name="tiny.cylinder", root=B.parent, chips=1, config=cfg, traffic=tr,
                limits={"limits": limits or dict.fromkeys(LIMITS, 1e-9)},
                end_to_end=[], per_layer=[])


def test_the_cylinder_matches_the_reference_in_float64():
    run = run_cell(tiny_cylinder(), SEED, 0.2, False, time.perf_counter(), device="cpu")
    assert run.failed == 0 and run.attempted >= 1
    for name in LIMITS:
        assert run.checks[name]["value"] < 1e-11, name
    assert all(c["ok"] for c in run.checks.values())


def test_float32_passes_the_limits_that_its_bf16_control_fails():
    control = load_json(B / "cells/cylinder4096.wake.json")["control"]["solver"]
    for seed in (SEED, SEED + 1):
        run = run_cell(tiny_cylinder("float32", F32_LIMITS), seed, 0.1, False,
                       time.perf_counter(), device="cpu")
        assert all(c["ok"] for c in run.checks.values()), run.checks
        ctl = run_cell(tiny_cylinder("float32", F32_LIMITS, control), seed, 0.1, False,
                       time.perf_counter(), device="cpu")
        assert ctl.failed == 0
        bad = [name for name in LIMITS if not ctl.checks[name]["ok"]]
        assert {"start_vel_gap", "step_vel_gap", "post_vel_gap"} <= set(bad), ctl.checks


def test_the_seed_sets_the_fields_and_the_markers_are_the_ports():
    from benchmark.flows import cylinder
    from fluca_tpu_torch.ibm.markers import circle_markers
    from fluca_tpu_torch.mesh.cart import CartMesh

    cfg = tiny_cylinder().config
    a = cylinder.initial_fields(cfg, SEED, "cpu")
    b = cylinder.initial_fields(cfg, SEED, "cpu")
    c = cylinder.initial_fields(cfg, SEED + 1, "cpu")
    assert torch.equal(a["v"][1], b["v"][1]) and not torch.equal(a["v"][1], c["v"][1])
    assert [tuple(x.shape) for x in a["U"]] == [(129, 64), (128, 65)]
    assert float(a["U"][0].min()) == float(a["U"][0].max()) == cfg["U_in"]
    mesh, _, _, mu, _ = cylinder.reference_setup(cfg, torch.float64, "cpu")
    assert mu == cfg["U_in"] * cfg["D"] / cfg["Re"]
    ref = cylinder.circle_markers(mesh, cfg["center"], cfg["D"] / 2, "roma3", torch.float64,
                                  "cpu")
    port_mesh = CartMesh.create(tuple(cfg["N"]))
    port_mesh.set_uniform_coordinates(0.0, cfg["L"][0], 0.0, cfg["L"][1])
    port = circle_markers(port_mesh, cfg["center"], cfg["D"] / 2, dtype=torch.float64,
                          device="cpu")
    assert torch.equal(ref.X, port.X) and torch.equal(ref.ds, port.ds)
    # the configuration's own count: ceil(pi D / h) with h = D / 64
    full = load_json(B / "configs/cylinder4096.json")
    h = full["L"][0] / full["N"][0]
    assert h == full["L"][1] / full["N"][1] == full["D"] / 64


def test_a_cylinder_run_loads_no_jax():
    import subprocess
    import sys

    from conftest import ROOT

    script = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from test_bench_cylinder import tiny_cylinder, SEED
from benchmark.harness import run_cell, result_line, forbidden_modules
run = run_cell(tiny_cylinder(), SEED, 0.1, True, time.perf_counter(), device="cpu")
result_line(run, False)
print(forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
