"""The benchmark's run of one cell: set-up, the measured window, the
traced steps, the step after the window, the comparison with the plain
reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by the names in ``BENCHMARK.json``:

- ``configs``' ``file``: the configuration's sizes (JSON), whose ``flow``
  names the module ``flows/<flow>.py`` that builds the program, draws
  the initial fields and sets up the plain reference's flow;
- ``traffic/<traffic>.json``: the solver the steps run, the set-up
  steps (two or more), the traced steps and the solve-quality gates;
- ``cells/<workload>.json``: the limits of the numbers compared;
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, ``read(run)`` -> a number or None (nothing to read). A metric
  named ``<base>.<cell suffix>`` (the same quantity in a cell whose
  end-to-end metric differs) is read by ``<base>.py``.

The window is a closed loop of one simulation: ``NS.step`` again and
again, each step ending in its own host read of ``converged``, until
``--seconds`` have passed; each step is timed on the host clock from the
call to its return.

``correct`` compares three steps that the program took through the same
object and call that the window drives, each against the plain
reference's step from the same input: the first set-up step (the
first-step path, from the seed's fields), the second (from the
program's own state after the first), and one more step after the window
and the traced steps (from the program's state there), so that whatever
the program does only after many steps is compared too. The window's
own steps are held to what they say: none failed, the fields are finite
after it, and the traffic's gates (the outer residual of every window
step, the mean flow kept).
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the compared steps: the first set-up step, the second, the one after the window
STEPS = ("start", "step", "post")
# top-level module names no run may have loaded once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "fluca_tpu")


class RunError(Exception):
    """A run that prints no result."""


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise RunError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @functools.cached_property
    def flow(self):
        """The module ``flows/<flow>.py`` of the configuration."""
        return load_module(self.root / "benchmark" / "flows" / f"{self.config['flow']}.py",
                           f"benchmark_flow_{self.config['flow']}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise RunError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "benchmark"
    return Cell(name=name, root=root, chips=int(w["chips"]), config=load_json(root / cfg["file"]),
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "cells" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader_path(root: Path, kind: str, name: str) -> Path:
    """``<root>/benchmark/<kind>/<name>.py``, or where there is none, that
    of ``name`` without its last dotted part, and so on."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "benchmark" / kind / (".".join(parts[:n]) + ".py")
        if path.exists():
            return path
    raise RunError(f"no reader for the metric {name!r} in benchmark/{kind}/")


def read_metrics(metrics, run, kind: str) -> dict:
    """{name: {"value", "unit"}} of the readers that found something."""
    out = {}
    for m in metrics:
        path = reader_path(run.cell.root, kind, m["name"])
        value = load_module(path, f"benchmark_{kind}_{path.stem}").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def program_solver(spec: dict):
    """The port's CNLinearConfig for a traffic file's ``solver``: the
    ``preset`` ("production" with ``outer``, ``mom``, ``schur``, or
    "default") and then its fields by name."""
    from fluca_tpu_torch.ns.cnlinear import CNLinearConfig

    spec = dict(spec)
    preset = spec.pop("preset", "default")
    if preset == "production":
        cfg = CNLinearConfig.production(spec.pop("outer"), spec.pop("mom"), spec.pop("schur"))
    elif preset == "default":
        cfg = CNLinearConfig()
    else:
        raise RunError(f"unknown solver preset {preset!r}")
    for k, v in spec.items():
        if not hasattr(cfg, k):
            raise RunError(f"CNLinearConfig has no field {k!r}")
        setattr(cfg, k, v)
    return cfg


@dataclass
class Run:
    """What one run measured: what the metric readers read."""

    cell: Cell
    device: str = "cuda"
    setup_s: float = math.nan
    step_s: list = field(default_factory=list)
    window_s: float = math.nan
    failed: int = 0
    ksp_iters: list = field(default_factory=list)
    ksp_rnorm: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    retention: float | None = None
    trace: object = None
    checks: dict = field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return len(self.step_s)


def mean_abs_u(state) -> float:
    return float(state["v"][0].abs().mean())


class Program:
    """The system under test for one cell: the port's NS object started
    from the seed's fields, stepped by ``NS.step``."""

    def __init__(self, cell: Cell, seed: int, device, solver=None):
        self.cell, self.device = cell, device
        spec = cell.traffic["solver"] if solver is None else solver
        self.ns, self.extra = cell.flow.build_program(cell.config, program_solver(spec), device)
        self.ns.error_if_step_failed = False
        self.restart(seed)

    def restart(self, seed: int) -> None:
        """Start the simulation anew from ``seed``'s fields at t = 0."""
        from fluca_tpu_torch.ns.ns import NSConvergedReason

        ns = self.ns
        ns.set_solution(**self.cell.flow.initial_fields(self.cell.config, seed, self.device))
        ns.step_index, ns.t, ns.last_diag = 0, 0.0, None
        ns.reason = NSConvergedReason.ITERATING

    def step(self) -> bool:
        """One step; whether it converged (a step that diverged or went
        non-finite does not)."""
        ns = self.ns
        k = ns.step_index
        ns.step()
        return ns.step_index == k + 1

    def close(self) -> None:
        self.ns = self.extra = None
        gc.collect()


def reference_step(cell: Cell, device, dtype_name="float64"):
    """The plain reference's step for ``cell``, in ``dtype_name``, on the
    flow that ``flows/<flow>.py`` sets up."""
    import torch

    from benchmark.reference.step import ReferenceStep

    dtype = getattr(torch, dtype_name)
    cfg = cell.config
    mesh, bcs, rho, mu, force = cell.flow.reference_setup(cfg, dtype, device)
    return ReferenceStep(mesh, bcs, rho, mu, cfg["dt"], cell.traffic["solver"], dtype, device,
                         body_force=force)


def reference_gaps(cell: Cell, seed: int, steps: dict, device, ref=None,
                   unchanged: bool = False) -> dict:
    """{name: ``compare.state_gaps``} of each compared step: ``steps``
    maps a name to (input, t, first, program's output), host states; an
    input None is the seed's fields. The reference takes its step from the
    same input in float64. With ``unchanged``, each entry also holds
    "unchanged": the gaps of the input itself, as a step that returned
    its state would read."""
    import torch

    from benchmark import compare

    ref = reference_step(cell, device) if ref is None else ref
    out = {}
    for name, (x, t, first, got) in steps.items():
        if x is None:
            x = cell.flow.initial_fields(cell.config, seed, device)
        want, _ = ref.step(compare.to_device(x, torch.float64, device), t, first)
        out[name] = compare.state_gaps(got, want)
        if unchanged:
            out[name]["unchanged"] = compare.state_gaps(x, want)
        want = None
    return out


def check(value, limit, op) -> dict:
    ok = value <= limit if op == "<=" else value >= limit
    return {"value": value, "limit": limit, "op": op, "ok": bool(ok and not math.isnan(value))}


def gap_checks(gaps: dict, limits: dict) -> dict:
    """The checks of the compared numbers that the cell's ``limits`` name
    (``<step>_<vel|p>_gap``), in that order."""
    out = {}
    for name, limit in limits.items():
        step, part, _ = name.split("_")
        out[name] = check(gaps[step][part], limit, "<=")
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device=None) -> Run:
    """One run of ``cell``: set-up, the window of ``seconds``, with
    ``trace`` the traced steps, one step after them, then the comparison.
    ``device``: the first GPU if None (a CPU device drives the same path
    with the program's plain versions, for the tests)."""
    import torch

    from benchmark import compare

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    tr = cell.traffic
    run = Run(cell=cell, device=device.type)

    # -- set-up: the kernel library, the program, the seed's fields, and
    # the set-up steps through the window's own call --------------------
    from fluca_tpu_torch.ops import cuda_stencil

    if cuda:
        cuda_stencil.load_library()
    prog = Program(cell, seed, device)
    ns = prog.ns
    u0 = mean_abs_u(ns.state)
    snaps = []
    for k in range(tr["setup_steps"]):
        if not prog.step():
            run.failed += 1
        if k < 2:
            snaps.append((compare.to_host(ns.state), ns.t))
    gates = tr.get("gates", {})
    if "retention_min" in gates:
        run.retention = mean_abs_u(ns.state) / u0
    sync()
    run.setup_s = time.perf_counter() - t_start

    # -- the window -------------------------------------------------------
    rnorms = []
    t0 = time.perf_counter()
    t_end = t0 + seconds
    t = t0
    while t < t_end:
        ok = prog.step()
        now = time.perf_counter()
        run.step_s.append(now - t)
        t = now
        run.failed += not ok
        rnorms.append(ns.last_diag["ksp_rnorm"])
        run.ksp_iters.append(ns.last_diag["ksp_iters"])
    run.window_s = t - t0
    run.ksp_rnorm = [float(x) for x in rnorms]
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0

    # -- the traced steps -------------------------------------------------
    if trace:
        from benchmark.trace import profile_steps
        from fluca_tpu_torch.ops.cuda_stencil import CSRC_DIR

        run.trace = profile_steps(prog.step, tr["trace_steps"], CSRC_DIR)

    # -- one more step, untimed, through the same object ------------------
    finite = compare.finite(ns.state)
    post_in, t_post = compare.to_host(ns.state), ns.t
    prog.step()
    post_out = compare.to_host(ns.state)
    prog.close()
    del ns
    if cuda:
        torch.cuda.empty_cache()

    # -- the plain reference ----------------------------------------------
    (s1, t1), (s2, _) = snaps
    gaps = reference_gaps(cell, seed, {"start": (None, 0.0, True, s1),
                                       "step": (s1, t1, False, s2),
                                       "post": (post_in, t_post, False, post_out)}, device)
    if cuda:
        torch.cuda.empty_cache()

    run.checks = {"failed_steps": check(run.failed, 0, "<="),
                  "finite": check(int(finite), 1, ">="),
                  **gap_checks(gaps, cell.limits["limits"])}
    if run.retention is not None:
        run.checks["retention"] = check(run.retention, gates["retention_min"], ">=")
    if "rnorm_max" in gates:
        run.checks["ksp_rnorm"] = check(max(run.ksp_rnorm), gates["rnorm_max"], "<=")
    return run


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_record(run: Run, chips: int) -> dict:
    import torch

    if run.device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    else:  # the tests' runs on the CPU
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = run.memory_peak_bytes
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    return dev


def result_line(run: Run, trace: bool) -> dict:
    cell = run.cell
    if trace:
        metrics = read_metrics(cell.per_layer, run, "metrics")
    else:
        metrics = read_metrics(cell.end_to_end, run, "end_to_end")
    out = {"correct": all(c["ok"] for c in run.checks.values()),
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device_record(run, cell.chips)}
    if trace:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"], "op": c["op"]}
                     for k, c in run.checks.items()}
    return out


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell needs {cell.chips} CUDA device(s); "
                           f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.set_num_threads(4)
        run = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
        bad = forbidden_modules()
        if bad:
            raise RunError(f"modules loaded that no run may load: {bad}")
        line = result_line(run, bool(args.trace))
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['op']} {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
