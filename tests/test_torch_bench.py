"""The port's bench (fluca_tpu_torch/bench.py) and probes
(fluca_tpu_torch/examples/) on the CPU at tiny sizes: every cell and
entry function runs with device="cpu", its result carries the
reference's keys (bench.py and examples/*.py, cited by line), the gates
count a breach for every limit missed or metric not measured, and the
channel's retention gate raises. None of it runs on the CPU unless
asked: without a card, device "cuda" raises."""

import functools
import json
import re
from pathlib import Path

import pytest
import torch

from fluca_tpu_torch import bench
from fluca_tpu_torch.examples import (
    kernels2d, kernels512, pin128, plans512, probe512, probe512split, probe_poisson512,
    profile512, steps2d,
)

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
# the keys of bench.py's results
SPMV_KEYS = {"frac", "gbps_copy", "gbps_spmv", "us_per_apply", "N"}  # :184-190
SHARDED_KEYS = {"ratio", "us_unsharded", "us_sharded"}  # :229-230
CHANNEL512_KEYS = {"steps_per_sec", "ms_per_step", "mcells_per_sec", "spmv_gbps",  # :526-542
                   "copy_roofline_at_shape_gbps", "solver", "ksp_rnorm", "grid", "kernels"}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
MAIN_KEYS = LINE_KEYS | {  # :236-299
    "cavity2d_256_steps_per_sec", "cavity3d_64_steps_per_sec", "channel3d_128_steps_per_sec",
    "channel3d_128_bf16_steps_per_sec", "channel3d_128_fast_steps_per_sec",
    "channel512_steps_per_sec", "channel512_spmv_gbps", "channel512_mcells_per_sec",
    "channel512_solver", "channel512_rnorm", "channel512_kernels", "sharded_1x1_ratio",
    "sharded_1x1_us"}
# profile512.py:121-296, its phases and gap rows
PROFILE_PHASES = {
    "A_apply_f32", "A_apply_bf16", "coupled_apply", "poisson_apply_lvl0", "vcycle_full",
    "dot+axpy_coupled", "mom_solve_bicgstab8_bf16", "mom_solve_jacobi8_bf16",
    "mom_solve_gcr8_bf16", "mom_solve_bicgstab8_f32", "mom_solve_jacobi8_f32",
    "schur_solve_cg6_f32", "abf_apply_bf16mom", "prep(B,diagA,Acoeffs,rhs)+reads",
    "FULL_o3m8s6_bf16mom", "copy_tm8", "copy_tm4", "copy+2rolls_tm8", "copy+2rolls_tm4",
    "spmv_lvl0", "copy_tm8_gbps", "copy_tm4_gbps", "copy+2rolls_tm8_gbps",
    "copy+2rolls_tm4_gbps", "spmv_lvl0_gbps"}


def tiny(fn, **sizes):
    """``fn`` with its sizes replaced by ``sizes`` whatever the caller
    passes, and its device kept."""
    @functools.wraps(fn)
    def call(*, device="cuda", **kw):
        return fn(**{**kw, **sizes}, device=device)
    return call


@pytest.fixture
def tiny_bench(monkeypatch):
    """bench.py's cells at tiny sizes."""
    for name, sizes in (("spmv_roofline", {"N": 32}), ("poisson3d_roofline", {"N": 8}),
                        ("sharded_1x1_ratio", {"N": 32}),
                        ("cavity_throughput", {"N": 16, "steps": 2}),
                        ("cavity3d_throughput", {"N": (8, 8, 8), "steps": 2}),
                        ("channel_throughput", {"N": 8, "steps": 2}),
                        ("channel512_bench", {"N": (16, 8, 8), "steps": 2})):
        monkeypatch.setattr(bench, name, tiny(getattr(bench, name), **sizes))


def test_slope_time_per_iter_counts_and_cancels():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    t = bench.slope_time_per_iter(fn, torch.zeros(3), iters_lo=2, iters_hi=5, repeats=2)
    assert len(calls) == (2 + 5) * (1 + 2) and t == t


def test_roofline_cells_on_the_cpu():
    r = bench.spmv_roofline(N=32, device=CPU)
    assert SPMV_KEYS <= set(r) and r["N"] == 32 and r["frac"] > 0
    r3 = bench.poisson3d_roofline(N=8, device=CPU)
    assert LINE_KEYS <= set(r3) and r3["metric"] == "poisson3d_spmv_roofline_fraction"
    assert r3["device"]["platform"] == "cpu"
    s = bench.sharded_1x1_ratio(N=32, device=CPU)
    assert set(s) == SHARDED_KEYS and s["ratio"] > 0


def test_step_cells_on_the_cpu():
    for rate in (bench.cavity_throughput(N=16, steps=2, device=CPU),
                 bench.cavity3d_throughput(N=(8, 8, 8), steps=2, device=CPU),
                 bench.channel_throughput(N=8, steps=2, device=CPU),
                 bench.channel_throughput(N=8, steps=2, fast=True, device=CPU),
                 bench.channel_throughput(N=8, steps=2, bf16=True, device=CPU)):
        assert rate > 0
    r = bench.channel512_bench(steps=2, N=(16, 8, 8), device=CPU)
    assert CHANNEL512_KEYS <= set(r)
    assert r["solver"] == bench.CHANNEL512_SOLVER and r["grid"] == [16, 8, 8]
    assert r["retention"] >= bench.RETENTION_MIN and r["ksp_rnorm"] == r["ksp_rnorm"]


def test_channel512_retention_gate_raises(monkeypatch):
    """A solver that loses the mean flow fails the cell; no other solver
    is tried."""
    made = []
    setup = bench.setup_channel_3d

    def decaying(**kw):
        ns = setup(**kw)
        advance = ns.advance

        def damped(n):
            advance(n)
            ns.state["v"] = tuple(0.5 * x for x in ns.state["v"])

        ns.advance = damped
        made.append(ns)
        return ns

    monkeypatch.setattr(bench, "setup_channel_3d", decaying)
    with pytest.raises(RuntimeError, match="retention"):
        bench.channel512_bench(steps=2, N=(16, 8, 8), device=CPU)
    assert len(made) == 1


def test_main_prints_the_reference_keys(tiny_bench, capsys):
    rc = bench.main(["--device", CPU])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert MAIN_KEYS <= set(line) and not any("error" in k for k in line)
    assert line["metric"] == "poisson_spmv_roofline_fraction"
    assert line["channel512_solver"] == bench.CHANNEL512_SOLVER
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert rc == (1 if bench.check_gates(line) else 0)


@pytest.mark.parametrize("flag,metric", [
    ("--quick", "poisson_spmv_roofline_fraction"),
    ("--cavity", "cavity_timesteps_per_sec"),
    ("--channel3d", "channel3d_timesteps_per_sec"),
    ("--channel512", "channel512_timesteps_per_sec"),
    ("--poisson3d", "poisson3d_spmv_roofline_fraction"),
])
def test_main_cells(tiny_bench, capsys, flag, metric):
    """bench.py:613-645: each flag prints its one line and is not gated."""
    assert bench.main([flag, "--device", CPU]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert LINE_KEYS <= set(line) and line["metric"] == metric
    if flag == "--channel512":
        assert CHANNEL512_KEYS <= set(line)


def test_gates_count_every_breach(capsys):
    good = {"channel512_rnorm": 350.0, "sharded_1x1_ratio": 1.02}
    assert bench.PERF_BANDS == {}
    assert bench.check_gates(good) == 0
    assert bench.check_gates({}) == 2  # neither measured
    assert bench.check_gates({**good, "channel512_rnorm": 501.0}) == 1
    assert bench.check_gates({**good, "sharded_1x1_ratio": 1.2}) == 1
    assert "not measured" in capsys.readouterr().err


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--quick"])
    with pytest.raises(RuntimeError, match="CUDA"):
        probe512split.main([])


@pytest.mark.parametrize("example", [kernels512, plans512, kernels2d])
def test_kernel_timing_examples_refuse_the_cpu(example):
    """The kernel timings (CUDA graphs of the kernels' launches) need a
    CUDA device: on the CPU they refuse, they do not time the plain
    versions."""
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        example.main(["--device", CPU])


def test_probe_entries_on_the_cpu():
    r = probe512.run(CPU, copy_cases=(((16, 8, 8), 8, "copy512_tm8"),
                                      ((32, 16), 4, "copy67MB_2d")),
                     momentum_shapes=((16, 8, 8),))
    assert set(r) == {"copy512_tm8", "copy67MB_2d", "mom3d_16x8x8_ms",
                      "mom3d_16x8x8_gbps_30stream"}
    assert {label for _, _, label in probe512.COPY_CASES} == {
        "copy512_tm8", "copy512_tm16", "copy256cube_tm8", "copy134MB_2d",
        "copy268MB_2d", "copy67MB_2d"}  # probe512.py:67-75
    r = probe512split.run(CPU, shape=(16, 8, 8), half=(8, 8, 8))
    assert set(r) == {"copy_134MB_single", "copy_2x67MB_two_kernels",  # :64-131
                      "copy_2x67MB_one_kernel", "copy_67MB_single",
                      "torch_mul_134MB", "torch_mul_67MB"}
    r = probe_poisson512.run(CPU, N=(16, 8, 8))
    assert set(r) == {"copy_tm8", "stencil_full", "stencil_rebuilt",  # :141-208
                      "stencil_noroll", "stencil_nocomp"}
    assert all(set(v) == {"ms", "eff_gbps"} for v in r.values())


def test_profile512_on_the_cpu(monkeypatch):
    # every phase runs; 1 and 3 applications per slope instead of 10-80
    monkeypatch.setattr(profile512, "slope_time_per_iter",
                        lambda fn, x, lo, hi: bench.slope_time_per_iter(fn, x, 1, 3, 1))
    r = profile512.run(CPU, N=(8, 8, 8))
    assert r["N"] == [8, 8, 8] and set(r["phases_ms"]) == PROFILE_PHASES
    assert r["launches"] == {}  # the CPU runs the plain versions


def test_probe_main_writes_only_where_asked(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(probe512split, "run", tiny(probe512split.run, shape=(16, 8, 8),
                                                   half=(8, 8, 8)))
    out = tmp_path / "split.json"
    assert probe512split.main(["--device", CPU, "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == printed and printed["device"]["platform"] == "cpu"
    assert probe512split.main(["--device", CPU]) == 0
    assert list(tmp_path.iterdir()) == [out]


def test_port_imports_no_jax_and_writes_no_reference_records():
    """The port and chip_smoke.py import neither JAX nor fluca_tpu, open
    none of the pre-port records the reference's probes write, and put
    no hard-coded checkout on sys.path (the reference's probes do)."""
    files = [*(REPO / "fluca_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    imports = re.compile(r"^\s*(import|from)\s+(jax|fluca_tpu)\b(?!_torch)", re.M)
    records = re.compile(r"open\([^)]*(PROBE512|PROBE512SPLIT|PROBE_POISSON512|PROFILE512)"
                         r"\.json|sys\.path\.insert")
    for f in files:
        text = f.read_text()
        assert not imports.search(text), f
        assert not records.search(text), f


def test_steps2d_on_the_cpu(monkeypatch, capsys):
    """The 2-D cavity timings run both solvers at every size asked for and
    report steps/s and the launches per step (none on the CPU, where the
    wrappers take the plain versions)."""
    monkeypatch.setattr(steps2d, "SIZES", {8: (0.01, 2, 2)})
    assert steps2d.main(["--sizes", "8", "--device", CPU]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(r) == {"package", "device", "8x8 f32_production", "8x8 bf16_both"}
    for label in steps2d.SOLVERS:
        run = r[f"8x8 {label}"]
        assert run["steps"] == 2 and run["steps_per_sec"] > 0 and run["launches_per_step"] == {}
    assert steps2d.solver("bf16_both").precond_scope == "both"
    assert steps2d.solver("f32_production").precond_dtype != "bfloat16"


def test_pin128_saves_and_compares_steps(monkeypatch, tmp_path, capsys):
    """The bf16 pin's step trace: a run compared with its own saved steps
    differs by 0 at every step; --repeats runs the bf16 solve again."""
    cavity = pin128.setup_cavity_2d
    monkeypatch.setattr(pin128, "setup_cavity_2d", lambda **kw: cavity(**{**kw, "N": 8}))
    trace = tmp_path / "steps.pt"
    assert pin128.main(["--device", CPU, "--steps", "2", "--save-steps", str(trace)]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(torch.load(trace)) == 2 and len(first["max_dev_bf16"]) == 1
    assert pin128.main(["--device", CPU, "--steps", "2", "--repeats", "2",
                        "--compare-steps", str(trace)]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["max_abs_vs_saved_by_step"] == [0.0, 0.0]
    assert r["max_dev_bf16"] == first["max_dev_bf16"] * 2
