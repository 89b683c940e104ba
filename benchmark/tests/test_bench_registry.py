"""The harness is driven by data: a configuration of a new flow (a 2-D
lid-driven cavity, with its program, initial fields and reference
set-up in a new ``flows/`` module), a cell and per-layer metrics added
as new files (and entries of BENCHMARK.json) in a copy of the benchmark
are found by name and run, with no existing file of the benchmark
edited; and ``run.py`` in a directory that holds only BENCHMARK.json
and the benchmark's files, on a machine with no card, exits non-zero
and prints no result."""

import hashlib
import json
import shutil
import subprocess
import sys
import time

import pytest
from conftest import LIMITS, ROOT, SEED

from benchmark import harness


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


CAVITY_FLOW = """
import torch

from benchmark.reference.bc import BCType, BoundaryCondition, zero_velocity_bc
from benchmark.reference.mesh import CartMesh


def lid(cfg):
    return lambda t, xs: (cfg["lid"] + 0.0 * xs[0], 0.0 * xs[0])


def build_program(cfg, solver, device):
    from fluca_tpu_torch.models.cavity import setup_cavity_2d

    ns = setup_cavity_2d(N=cfg["N"], Re=cfg["Re"], dt=cfg["dt"], max_steps=10**9,
                         lid_speed=cfg["lid"], dtype=getattr(torch, cfg["dtype"]), device=device)
    ns.impl.cfg = solver
    return ns, None


def initial_fields(cfg, seed, device):
    N, dtype = cfg["N"], getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    v = 0.01 * torch.randn((2, N, N), generator=gen, device=device, dtype=dtype)
    z = torch.zeros((N, N), dtype=dtype, device=device)
    return {"v": (v[0], v[1]),
            "U": (torch.zeros((N + 1, N), dtype=dtype, device=device),
                  torch.zeros((N, N + 1), dtype=dtype, device=device)),
            "p": z, "phalf": z.clone()}


def reference_setup(cfg, dtype, device):
    mesh = CartMesh.create((cfg["N"], cfg["N"]))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    wall = zero_velocity_bc()
    bcs = [wall, wall, wall, BoundaryCondition(BCType.VELOCITY, velocity=lid(cfg))]
    return mesh, bcs, 1.0, 1.0 / cfg["Re"], None
"""


def add_dummy(root):
    """A 2-D cavity flow, its configuration, traffic and cell, and a
    per-layer metric of its own plus one read by an existing reader
    under a cell suffix: new files and new entries only."""
    b = root / "benchmark"
    (b / "flows/dummycavity.py").write_text(CAVITY_FLOW)
    (b / "configs/dummy.json").write_text(json.dumps(
        {"flow": "dummycavity", "N": 16, "Re": 100.0, "lid": 1.0, "dt": 0.01,
         "dtype": "float64"}))
    (b / "traffic/dummy.json").write_text(json.dumps(
        {"solver": {"preset": "production", "outer": 2, "mom": 4, "schur": 4},
         "setup_steps": 2, "trace_steps": 1}))
    (b / "cells/dummy.cell.json").write_text(json.dumps(
        {"limits": dict.fromkeys(LIMITS, 1e-11)}))
    (b / "metrics/dummy_metric.py").write_text(
        "LAYER = 'device'\nSOURCE = 'program_counter'\nUNIT = 'steps'\nMOVES = 'steps_per_s'\n\n"
        "def read(run):\n    return float(run.attempted)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "a test", "reduced": [], "why": "a test",
                             "file": "benchmark/configs/dummy.json"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "steps_per_s.dummy", "unit": "steps/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    for name in ("dummy_metric", "launches_per_step.dummy"):
        bench["per_layer"].append({"name": name, "unit": "steps", "better": "higher",
                                   "source": "program_counter", "layer": "device",
                                   "moves": "steps_per_s.dummy", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found_by_name_and_run(copy):
    before = digest(copy)
    add_dummy(copy)
    after = digest(copy)
    assert all(after[k] == v for k, v in before.items())
    cell = harness.load_cell("dummy.cell", root=copy)
    assert cell.config["N"] == 16 and cell.traffic["setup_steps"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric", "launches_per_step.dummy"]
    assert harness.reader_path(copy, "metrics", "launches_per_step.dummy") == (
        copy / "benchmark/metrics/launches_per_step.py")
    shipped = harness.load_cell("channel512.shipped", root=copy)
    assert "dummy_metric" not in [m["name"] for m in shipped.per_layer]
    # the 2-D cell's whole run on the CPU, the reference from the new flow module
    run = harness.run_cell(cell, SEED, 0.2, False, time.perf_counter(), device="cpu")
    assert run.attempted >= 1 and all(c["ok"] for c in run.checks.values()), run.checks
    assert set(harness.STEPS) == {k.split("_")[0] for k in run.checks if k.endswith("_gap")}
    line = harness.result_line(run, False)
    assert line["correct"] and set(line["metrics"]) == {"steps_per_s.dummy", "setup_s"}
    got = harness.read_metrics(cell.per_layer, run, "metrics")
    assert got == {"dummy_metric": {"value": float(run.attempted), "unit": "steps"}}


@pytest.mark.parametrize("workload", ["dummy.cell", "channel512.shipped", "no.such.cell"])
def test_run_without_a_card_prints_no_result(copy, workload):
    add_dummy(copy)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                        str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=copy)
    assert r.returncode != 0
    assert '"metrics"' not in r.stdout
    assert r.stderr


def test_every_metric_reader_declares_its_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        path = harness.reader_path(ROOT, "metrics", m["name"])
        mod = harness.load_module(path, "m")
        suffix = m["name"][len(path.stem):]
        assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES + suffix) == (
            m["layer"], m["source"], m["unit"], m["moves"]), m["name"]
    for m in bench["end_to_end"]:
        harness.reader_path(ROOT, "end_to_end", m["name"])
    for w in bench["workloads"]:
        assert (ROOT / "benchmark/cells" / f"{w['name']}.json").exists()
        assert (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").exists()
