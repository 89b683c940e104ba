"""The program's spans in the benchmark (``benchmark/spans.py``): a
synthetic trace attributes each kernel by the link to its launch, not by
time overlap, with self times and ``<span>/<op>`` idle gaps; the chain's
byte counts against PERF.md's bounds; the passes on a tiny cell on the
CPU, and nothing read from a program without spans; on a card, the
launch-by-key counter against the recorder over one step of a 64^3
channel."""

import json
import shutil
import time

import pytest
from conftest import ROOT, SEED, tiny_cell
from test_bench_registry import add_dummy

from benchmark import harness, spans
from benchmark.roofline import bound_seconds
from benchmark.roofline_chain3d import chain3d_bytes


def ev(name, start, end, id=0, linked=0, device="cpu"):
    return {"name": name, "device": device, "start": start, "end": end, "id": id,
            "linked": linked}


# the log of one step: NS_Step > step.outer > abf > abf.schur, then step.project
RECORDS = [["NS_Step", -1, 0, 0, 0], ["step.outer", 0, 0, 0, 0], ["abf", 1, 0, 0, 0],
           ["abf.schur", 2, 0, 0, 0], ["step.project", 0, 0, 0, 0]]
NAMES = {"NS_Step", "step.outer", "abf", "abf.schur", "step.project"}


def synthetic():
    """The host runs ahead of the card: every kernel runs after the span
    that launched it closed on the host."""
    return [
        ev("NS_Step", 0, 100, id=1),
        ev("step.outer", 1, 40, id=2),
        ev("abf", 5, 30, id=3),
        ev("abf.schur", 6, 20, id=4),
        ev("step.project", 41, 50, id=5),
        ev("aten::add", 2, 3, id=10),        # in step.outer's own time
        ev("aten::dot", 7, 8, id=11),        # in abf.schur
        ev("aten::mul", 42, 43, id=12),      # in step.project
        ev("aten::_local_scalar_dense", 60, 90, id=13),  # the converged read
        ev("cudaLaunchKernel", 2.5, 2.8, id=900, linked=10),
        # kernels, on the card's clock, long after their spans closed
        ev("vectorized_elementwise_kernel", 50, 54, id=900, linked=10, device="cuda"),
        ev("dot_kernel", 54, 60, id=901, linked=11, device="cuda"),
        # a port kernel linked straight to its span
        ev("void poisson3d_kernel<float, 2, false, -1>", 62, 72, id=902, linked=4,
           device="cuda"),
        ev("mul_kernel", 80, 82, id=903, linked=12, device="cuda"),
        # the span's range on the card's timeline: no kernel
        ev("abf.schur", 50, 90, device="cuda"),
        ev("Memcpy DtoH", 95, 96, id=904, linked=13, device="cuda"),
    ]


def test_kernels_go_to_the_span_of_their_launch_not_the_overlap():
    a = spans.attribute(synthetic(), RECORDS, NAMES)
    assert a.steps == 1 and a.uncorrelated == 0
    assert [(n, round(s * 1e6, 6), r) for n, s, r in a.kernels] == [
        ("vectorized_elementwise_kernel", 4.0, 1), ("dot_kernel", 6.0, 3),
        ("void poisson3d_kernel<float, 2, false, -1>", 10.0, 3), ("mul_kernel", 2.0, 4)]
    self_ms = a.self_ms()
    assert self_ms == pytest.approx({"step.outer": 0.004, "abf.schur": 0.016,
                                     "step.project": 0.002})
    assert a.inclusive_ms("step.outer") == pytest.approx(0.020)
    assert a.inclusive_ms("abf") == pytest.approx(0.016)
    assert a.inclusive_ms("NS_Step") == pytest.approx(a.total_ms) == pytest.approx(0.022)
    assert a.inclusive_ms("ibm.force") is None
    # the card idles 0-50, 60-62, 72-80, 82-95 and 96-100 (the span's range
    # is no activity): named by the span and the torch op at each middle
    assert a.idle == pytest.approx({
        "abf/(between torch ops)": 50e-6, "NS_Step/(between torch ops)": 4e-6,
        "NS_Step/aten::_local_scalar_dense": 2e-6 + 8e-6 + 13e-6})


def test_an_unlinked_port_kernel_goes_by_launch_order():
    events = synthetic()
    events[12]["linked"] = 0
    a = spans.attribute(events, RECORDS, NAMES, port_kernels=frozenset({"poisson3d_kernel"}),
                        launches=[("poisson3d", 3)])
    assert a.uncorrelated == 1 and a.by_order == 1
    assert a.self_ms()["abf.schur"] == pytest.approx(0.016)
    b = spans.attribute(events, RECORDS, NAMES, port_kernels=frozenset({"poisson3d_kernel"}))
    assert b.uncorrelated == 1 and b.self_ms()[spans.NO_SPAN] == pytest.approx(0.010)


def test_a_log_the_trace_does_not_hold_is_refused():
    with pytest.raises(RuntimeError, match="program ranges"):
        spans.attribute(synthetic(), RECORDS + [["abf.post", 2, 0, 0, 0]], NAMES | {"abf.post"})


C512, C128, PER = (512, 256, 256), (128, 128, 128), (True, False, True)


@pytest.mark.parametrize("shape,stage,ms", [
    (C512, "coupled", 0.681), (C512, "pre", 0.441), (C512, "post", 0.521),
    (C128, "coupled", 0.0426), (C128, "pre", 0.0276), (C128, "post", 0.0326),
])
def test_chain3d_bound(shape, stage, ms):
    """PERF.md's Chain3D bounds (kernels512.py's shapes: the channel's
    periodic x and z, f32)."""
    got = bound_seconds(chain3d_bytes(stage, shape, PER, "float32")) * 1e3
    assert got == pytest.approx(ms, abs=0.5 * 10 ** -(len(str(ms).split(".")[1])))
    assert bound_seconds(chain3d_bytes(stage, shape, PER, "float64")) * 1e3 == \
        pytest.approx(2 * got)


def test_the_passes_on_a_tiny_cell():
    cell = tiny_cell("sphere")
    p = spans.run_passes(cell, SEED, "cpu")
    n = cell.traffic["trace_steps"]
    assert p.steps == n and len(p.step_ms_on) == len(p.step_ms_off) == n
    assert p.counters["host_reads"] == n
    assert p.counters["iters.outer"] == 3 * n
    assert {"NS_Step", "step.rhs", "ibm.force", "step.outer", "abf.schur",
            "mg.vcycle"} <= set(p.summary)
    assert p.attribution is None  # no card: no kernels to attribute
    got = spans.values(p)
    assert got["host_reads_per_step"] == 1.0
    assert 0 < got["host_busy_ms_per_step"] < p.summary["NS_Step"]["ms"] / n + 1e-9
    assert got["krylov_ms_per_step"] is None and got["roofline_pct_chain3d"] is None


def test_a_traced_run_makes_the_passes_in_a_process_of_their_own(tmp_path, capsys,
                                                                  monkeypatch):
    """The registry test's 2-D cavity cell, traced on the CPU: the readers
    get the passes' numbers from ``python -m benchmark.spans``, run in the
    copy of the benchmark (the program from this checkout)."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_dummy(tmp_path)
    cell = harness.load_cell("dummy.cell", root=tmp_path)
    run = harness.run_cell(cell, SEED, 0.2, True, time.perf_counter(), device="cpu")
    assert spans.host_reads_per_step(run) == 1.0
    assert spans.host_busy_ms_per_step(run) > 0
    assert spans.schur_ms_per_step(run) is None
    line = capsys.readouterr().err.splitlines()[-1]
    rec = json.loads(line.removeprefix("spans: "))
    assert rec["counters_per_step"]["host_reads"] == 1.0 and rec["window_step_ms_median"] > 0
    # an untraced run reads nothing
    assert spans.host_reads_per_step(harness.Run(cell=cell, device="cpu")) is None


def test_a_program_without_spans_runs_no_passes(monkeypatch):
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    monkeypatch.setattr(spans.subprocess, "run", None)
    run = harness.Run(cell=tiny_cell("channel"), device="cpu", trace=object())
    assert spans.passes(run) is None
    assert spans.host_reads_per_step(run) is None and spans.roofline_pct_chain3d(run) is None


def test_a_cpu_profile_of_a_step_matches_its_log():
    """The Kineto events of a real profile hold one host range per span of
    the log, in its order (no kernels on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    from fluca_tpu_torch.utils import profiling

    prog = harness.Program(tiny_cell("channel"), SEED, "cpu")
    prog.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing() as log:
            prog.step()
    events = spans.profiler_events(prof)
    a = spans.attribute(events, log.records, set(log.summary()))
    assert a.kernels == [] and a.steps == 1
    # no device activity: the whole step is one gap, named at its middle
    (root,) = [e for e in events if e["name"] == "NS_Step"]
    ((name, secs),) = a.idle.items()
    assert name.split("/")[0] in log.summary()
    assert secs == pytest.approx((root["end"] - root["start"]) * 1e-6)
    assert any(e["name"].startswith("aten::") for e in events)


def test_the_seed_of_the_command_line():
    assert spans.run_seed(["run.py", "--workload", "x", "--seed", str(SEED)]) == SEED
    assert spans.run_seed(["run.py", f"--seed={SEED}"]) == SEED
    assert spans.run_seed(["run.py"], default=7) == 7


@pytest.mark.card
def test_launch_counter_against_the_recorder_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels launch only on the GPU")
    from benchmark.trace import Recorder
    from fluca_tpu_torch.models.channel import setup_channel_3d
    from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
    from fluca_tpu_torch.ops import cuda_stencil

    cuda_stencil.load_library()
    ns = setup_channel_3d(N=(64, 64, 64), dt=2e-3, max_steps=10**9, dtype=torch.float32,
                          device="cuda")
    ns.impl.cfg = CNLinearConfig.production(2, 6, 8)
    ns.step()
    cuda_stencil.reset_launch_counts()
    with Recorder() as rec:
        ns.step()
    got = {}
    for (kernel, shape, sfx, band), n in cuda_stencil.launches_by_key().items():
        if kernel in ("poisson3d", "momentum3d"):
            key = (kernel, shape, band, sfx)
            got[key] = got.get(key, 0) + n
    want = {}
    sfx = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}
    for op, _, shape, periodic, dtype in rec.calls:
        key = (op, shape, periodic, sfx[dtype])
        want[key] = want.get(key, 0) + 1
    assert got == want and sum(want.values()) > 0
