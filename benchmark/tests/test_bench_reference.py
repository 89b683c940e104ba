"""The plain reference against the port's step, in float64 on the CPU,
through the harness's own run (set-up steps, a window, one more step
from the program's state)."""

import time

import pytest
import torch
from conftest import LIMITS, SEED, tiny_cell

from benchmark.harness import program_solver, run_cell
from benchmark.reference.step import DEFAULTS, solver_config


@pytest.mark.parametrize("kind", ["channel", "sphere"])
def test_reference_matches_the_program_in_float64(kind):
    run = run_cell(tiny_cell(kind), SEED, 0.2, False, time.perf_counter(), device="cpu")
    assert run.failed == 0 and run.attempted >= 1
    for name in LIMITS:
        assert run.checks[name]["value"] < 1e-11, name
    assert all(c["ok"] for c in run.checks.values())


def test_reference_defaults_are_the_ports():
    from fluca_tpu_torch.ns.cnlinear import CNLinearConfig

    port = CNLinearConfig()
    for k, v in DEFAULTS.items():
        assert getattr(port, k) == v, k


@pytest.mark.parametrize("traffic", ["shipped", "wake", "rtol"])
def test_traffic_solvers_agree(traffic):
    from conftest import B

    from benchmark.harness import load_json

    spec = load_json(B / f"traffic/{traffic}.json")["solver"]
    ref = solver_config(spec)
    port = program_solver(spec)
    for k, v in ref.items():
        assert getattr(port, k) == v, k


def test_the_seed_sets_the_fields():
    from benchmark.flows import channel

    cfg = tiny_cell("channel").config
    a = channel.initial_fields(cfg, SEED, "cpu")
    b = channel.initial_fields(cfg, SEED, "cpu")
    c = channel.initial_fields(cfg, SEED + 1, "cpu")
    assert torch.equal(a["v"][0], b["v"][0])
    assert not torch.equal(a["v"][0], c["v"][0])
