"""The program's own spans and counters in a ``--trace 1`` run: two passes
over a second simulation of the cell, after the harness's traced steps
(pass A, the program's tracing off) and its comparison.

The harness has no call for them, so the readers of the span metrics
make them, once a run (``passes``), in a process of their own
(``python3 -m benchmark.spans --workload <cell> --seed <n>``): a new
program from the run's seed, started as the harness starts it (the
traffic's set-up steps), then

- pass B: ``trace_steps`` steps with tracing off and as many with the
  program's spans on and no profiler, in turns, each timed on the host
  clock: the host ms of each span and the counters per step, and what
  tracing costs when on;
- pass C: ``trace_steps`` steps with the spans on under ``torch.profiler``
  as pass A has it. Each kernel goes to the innermost program span that
  was open when it was launched: the profiler links a kernel to the
  innermost host range (a torch operation or a program span) that was
  open at its launch call (its ``linked_correlation_id``); a torch
  operation falls to the innermost span around it on the host. The
  port's own kernels, launched through ctypes from its library, go the
  same way; one the profiler linked to nothing goes by launch order on the
  stream to the span that was open at its ``_Kernel`` launch. The spans'
  ranges on the card's timeline are set apart from the kernels. Each idle
  gap of the card is named ``<innermost span>/<innermost torch op>`` at
  its middle.

The process of their own keeps pass B's host times clean: in the run's
own process, after the profiler of pass A and the reference's float64
steps, the same steps took the host 10-35 % longer (PERF.md). A program
without the spans (``utils.profiling.tracing``) gives nothing to read,
and nothing is run for it. The run prints one line ``spans: {...}`` on
standard error with everything the passes found.
"""

from __future__ import annotations

import bisect
import json
import re
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

from benchmark.trace import _NOT_KERNEL, _NOT_OPS, matches, port_kernel_names

PASSES_ATTR = "_span_passes"
BETWEEN = "(between torch ops)"
NO_SPAN = "(no span)"


def _profiling():
    """The program's tracing module where it has spans, else None."""
    from fluca_tpu_torch.ops import cuda_stencil
    from fluca_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing") or not hasattr(cuda_stencil, "launches_by_key"):
        return None
    return profiling


def run_seed(argv=None, default: int = 0) -> int:
    """The ``--seed`` of this process's command line."""
    argv = sys.argv if argv is None else argv
    for i, a in enumerate(argv):
        if a == "--seed" and i + 1 < len(argv):
            return int(argv[i + 1])
        if a.startswith("--seed="):
            return int(a.split("=", 1)[1])
    return default


@dataclass
class Attribution:
    """Pass C reduced: ``steps`` traced steps; ``records`` the log's spans
    [name, parent, ...]; ``kernel_s`` per record index the device seconds of
    the kernels that fell to it (-1: to no span); ``kernels`` (name,
    seconds, record) of every kernel; ``idle`` {gap name: seconds}."""

    steps: int
    records: list
    kernel_s: dict
    kernels: list
    idle: dict
    to_span: int = 0
    uncorrelated: int = 0
    by_order: int = 0

    def self_ms(self) -> dict:
        """Device ms per step of the kernels whose innermost span has each
        name."""
        out = {}
        for idx, s in self.kernel_s.items():
            name = self.records[idx][0] if idx >= 0 else NO_SPAN
            out[name] = out.get(name, 0.0) + s * 1e3 / self.steps
        return out

    def inclusive_ms(self, name: str) -> float | None:
        """Device ms per step of the kernels under spans named ``name``
        (theirs and their children's); None where no such span ran."""
        if not any(r[0] == name for r in self.records):
            return None
        tot = 0.0
        for idx, s in self.kernel_s.items():
            while idx >= 0 and self.records[idx][0] != name:
                idx = self.records[idx][1]
            if idx >= 0:
                tot += s
        return tot * 1e3 / self.steps

    @property
    def total_ms(self) -> float:
        return sum(self.kernel_s.values()) * 1e3 / self.steps


def _innermost(starts, ends, parents, t) -> int:
    """The index of the innermost of nested ranges (sorted by start, each
    with its ``parents`` index, -1 for none) that holds ``t``, -1 for none:
    the last to start at or before ``t``, or its first ancestor that holds
    ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ends[i] < t:
        i = parents[i]
    return i


def _nesting(ranges) -> list:
    """The parent index of each of ``ranges`` (sorted by start, then the
    longest first): the innermost earlier range still open at its start."""
    parents, stack = [], []
    for s, e in ranges:
        while stack and ranges[stack[-1]][1] < s:
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        stack.append(len(parents) - 1)
    return parents


def attribute(events, records, span_names, port_kernels=frozenset(),
              launches=()) -> Attribution:
    """Reduce profiler events to an ``Attribution``.

    ``events``: dicts with "name", "device" ("cuda" or "cpu"), "start",
    "end" (µs, the profiler's clock), "id" and "linked" (the id of the
    host range a device or runtime event was launched under, 0 for none).
    ``records``: the pass's span log records, in the order they began,
    each of which has one host range named as it is, in the same order.
    ``launches``: (kernel name, record) of the port's launches in order,
    for kernels linked to nothing. The idle gaps lie between the first
    ``NS_Step`` range's start and the last one's end."""
    # the host ranges a launch can be linked to: torch operations and the
    # program's spans (runtime calls carry a link of their own)
    host = [e for e in events if e["device"] == "cpu" and not e["linked"]]
    spans = sorted((e for e in host if e["name"] in span_names),
                   key=lambda e: (e["start"], -e["end"]))
    if [e["name"] for e in spans] != [r[0] for r in records]:
        raise RuntimeError(f"the trace holds {len(spans)} program ranges, the log "
                           f"{len(records)}, or in another order")
    starts = [e["start"] for e in spans]
    ends = [e["end"] for e in spans]
    parents = [r[1] for r in records]
    span_of_id = {e["id"]: i for i, e in enumerate(spans)}
    ops = {e["id"]: e for e in host if e["name"] not in span_names}
    device = [e for e in events if e["device"] == "cuda" and e["name"] not in span_names]
    kernels = [e for e in device if not e["name"].startswith(_NOT_KERNEL)]
    roots = [(starts[i], ends[i]) for i, r in enumerate(records) if r[0] == "NS_Step"]
    window = (min(s for s, _ in roots), max(e for _, e in roots)) if roots else (0, 0)

    # port kernels the profiler linked to nothing: by launch order
    port_re = re.compile(r"\b(?:" + "|".join(map(re.escape, sorted(port_kernels))) + r")\b")
    port = sorted((e for e in kernels if port_kernels and port_re.search(e["name"])),
                  key=lambda e: e["start"])
    order = {}
    if len(port) == len(launches):
        order = {id(e): rec for e, (_, rec) in zip(port, launches)}
    out = Attribution(steps=max(len(roots), 1), records=records, kernel_s={}, kernels=[],
                      idle={})
    for e in kernels:
        src = e["linked"]
        if src in span_of_id:
            rec = span_of_id[src]
            out.to_span += 1
        elif src in ops:
            rec = _innermost(starts, ends, parents, ops[src]["start"])
        else:
            out.uncorrelated += 1
            rec = order.get(id(e), -1)
            out.by_order += id(e) in order
        s = (e["end"] - e["start"]) * 1e-6
        out.kernel_s[rec] = out.kernel_s.get(rec, 0.0) + s
        out.kernels.append((e["name"], s, rec))

    # idle gaps of the card inside the window, named by the host at their middle
    busy = []
    for e in sorted(device, key=lambda e: e["start"]):
        s, t = max(e["start"], window[0]), min(e["end"], window[1])
        if t <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    gaps, t = [], window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    torch_ops = sorted((e for e in ops.values() if not e["name"].startswith(_NOT_OPS + ("[",))),
                       key=lambda e: (e["start"], -e["end"]))
    op_ranges = [(e["start"], e["end"]) for e in torch_ops]
    op_starts, op_ends = [r[0] for r in op_ranges], [r[1] for r in op_ranges]
    op_parents = _nesting(op_ranges)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        rec = _innermost(starts, ends, parents, mid)
        j = _innermost(op_starts, op_ends, op_parents, mid)
        op = torch_ops[j]["name"] if j >= 0 else BETWEEN
        name = f"{records[rec][0] if rec >= 0 else NO_SPAN}/{op}"
        out.idle[name] = out.idle.get(name, 0.0) + (e - s) * 1e-6
    return out


def profiler_events(prof) -> list:
    """The events of a ``torch.profiler`` run as ``attribute`` takes them,
    from the profiler's Kineto events (their correlation ids, which
    ``prof.events()`` does not keep in every torch version)."""
    from torch.autograd import DeviceType

    return [{"name": ev.name(),
             "device": "cuda" if ev.device_type() == DeviceType.CUDA else "cpu",
             "start": ev.start_ns() * 1e-3, "end": ev.end_ns() * 1e-3,
             "id": ev.correlation_id(), "linked": ev.linked_correlation_id()}
            for ev in prof.profiler.kineto_results.events()]


@dataclass
class Passes:
    """What passes B and C found (``passes``)."""

    steps: int
    step_ms_off: list
    step_ms_on: list
    summary: dict
    counters: dict
    attribution: Attribution | None
    launches: dict = field(default_factory=dict)
    chains: dict = field(default_factory=dict)
    # host seconds of the set-up, pass B, pass C and the attribution
    seconds: list = field(default_factory=list)

    def per_step(self, counter: str) -> float:
        return self.counters.get(counter, 0) / self.steps


def _launch_recorder(cuda_stencil, profiling, out: list):
    """Wrap ``_Kernel._launch`` and ``_launch_entry`` to append (kernel
    name, the innermost open span's record) to ``out``; returns the undo."""
    K = cuda_stencil._Kernel
    saved = (K._launch, K._launch_entry)

    def wrap(orig):
        def call(obj, *a, **k):
            log = profiling.current()
            out.append((obj.name, log.stack[-1] if log is not None and log.stack else -1))
            return orig(obj, *a, **k)
        return call

    K._launch, K._launch_entry = wrap(saved[0]), wrap(saved[1])

    def undo():
        K._launch, K._launch_entry = saved
    return undo


def run_passes(cell, seed: int, device) -> Passes | None:
    """Passes B and C for ``cell`` from ``seed`` on ``device`` (None where
    the program has no spans)."""
    profiling = _profiling()
    if profiling is None:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import Program
    from fluca_tpu_torch.ops import cuda_stencil

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tr = cell.traffic
    n = int(tr["trace_steps"])
    clock = [time.perf_counter()]
    prog = Program(cell, seed, device)
    try:
        for _ in range(int(tr["setup_steps"])):
            prog.step()
        sync()
        clock.append(time.perf_counter())

        def timed():
            t = time.perf_counter()
            prog.step()
            return (time.perf_counter() - t) * 1e3

        # off and on in turns, so that both see the same steps' drift
        off, on, logs = [], [], []
        for _ in range(n):
            off.append(timed())
            with profiling.tracing() as log:
                on.append(timed())
            logs.append(log)
        clock.append(time.perf_counter())
        chain = getattr(prog.ns.impl, "_chain", None)
        chains = {} if chain is None else {chain.fingerprint: (chain.shape, chain.periodic)}

        # pass C
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        cuda_stencil.reset_launch_counts()
        launched = []
        undo = _launch_recorder(cuda_stencil, profiling, launched)
        try:
            with profile(activities=acts) as prof:
                with profiling.tracing() as log_c:
                    for _ in range(n):
                        prog.step()
                sync()
        finally:
            undo()
        clock.append(time.perf_counter())
        launches = cuda_stencil.launches_by_key()
        att = None
        if cuda:
            att = attribute(profiler_events(prof), log_c.records, set(log_c.summary()),
                            port_kernel_names(cuda_stencil.CSRC_DIR), launched)
        clock.append(time.perf_counter())
    finally:
        prog.close()
    summary, counters = {}, {}
    for log in logs:
        for name, v in log.summary().items():
            s = summary.setdefault(name, dict.fromkeys(v, 0))
            for k in v:
                s[k] += v[k]
        for name, k in log.counters.items():
            counters[name] = counters.get(name, 0) + k
    return Passes(steps=sum(log.steps for log in logs), step_ms_off=off, step_ms_on=on,
                  summary=summary, counters=counters, attribution=att, launches=launches,
                  chains=chains, seconds=[b - a for a, b in zip(clock, clock[1:])])


def record(p: Passes) -> dict:
    """Everything the passes found, for the log of the run."""
    out = {"seconds": p.seconds, "steps": p.steps, "step_ms_off": p.step_ms_off,
           "step_ms_on": p.step_ms_on,
           "host_ms_per_step": {k: {"count": v["count"] / p.steps, "ms": v["ms"] / p.steps,
                                    "self_ms": v["self_ms"] / p.steps}
                                for k, v in p.summary.items()},
           "counters_per_step": {k: v / p.steps for k, v in sorted(p.counters.items())}}
    a = p.attribution
    if a is not None:
        out["device_self_ms_per_step"] = dict(sorted(a.self_ms().items(),
                                                     key=lambda kv: -kv[1]))
        out["device_ms_per_step"] = {name: a.inclusive_ms(name) for name in p.summary}
        out["kernel_ms_per_step"] = a.total_ms
        out["kernels_linked"] = {"to_span": a.to_span,
                                 "to_op": len(a.kernels) - a.to_span - a.uncorrelated,
                                 "to_nothing": a.uncorrelated, "by_launch_order": a.by_order}
        out["idle_gaps_by_span"] = [[k, v] for k, v in sorted(a.idle.items(),
                                                              key=lambda kv: -kv[1])[:10]]
    return out


# -- the metrics, from the passes ---------------------------------------------
def _chain3d_share(p: Passes, a: Attribution):
    from benchmark.roofline import bound_seconds
    from benchmark.roofline_chain3d import chain3d_bytes

    t = sum(s for name, s, _ in a.kernels if matches(name, "chain3d_kernel"))
    bound = 0.0
    for (kernel, shape, sfx, band), k in p.launches.items():
        if kernel.startswith("chain3d_") and k:
            dtype = {"f32": "float32", "f64": "float64"}[sfx]
            bound += k * bound_seconds(chain3d_bytes(kernel.removeprefix("chain3d_"), shape,
                                                     p.chains[band][1], dtype))
    return 100.0 * bound / t if t > 0 and bound > 0 else None


def _host_busy(p: Passes):
    if "NS_Step" not in p.summary:
        return None
    read = p.summary.get("host_read", {"ms": 0.0})["ms"]
    return (p.summary["NS_Step"]["ms"] - read) / p.steps


def _on_card(fn):
    return lambda p: None if p.attribution is None else fn(p, p.attribution)


# {metric: (its number from the passes, what it reads)}
METRICS = {
    "krylov_ms_per_step": (
        _on_card(lambda p, a: a.self_ms().get("step.outer")),
        "Device ms per step of the kernels in ``step.outer``'s own time: the outer Krylov "
        "solver's algebra, outside its A (``outer.apply``) and its M (``abf``)."),
    "momentum_ms_per_step": (
        _on_card(lambda p, a: a.inclusive_ms("abf.momentum")),
        "Device ms per step of the kernels under ``abf.momentum``."),
    "schur_ms_per_step": (
        _on_card(lambda p, a: a.inclusive_ms("abf.schur")),
        "Device ms per step of the kernels under ``abf.schur``: CG (or the V-cycle "
        "iteration) and the multigrid inside it."),
    "ibm_ms_per_step": (
        _on_card(lambda p, a: a.inclusive_ms("ibm.force")),
        "Device ms per step of the kernels under ``ibm.force``."),
    "roofline_pct_chain3d": (
        _on_card(_chain3d_share),
        "The chain's stages against their memory roofline, in %: the bound time of every "
        "pass C launch of a ``chain3d_*`` wrapper (the launch-by-key counter: stage, shape, "
        "instance and band set, the band set's periodicity from the program's chain) over "
        "the device time of the ``chain3d_kernel`` launches in the same steps."),
    "host_reads_per_step": (
        lambda p: p.counters.get("host_reads", 0) / p.steps,
        "Device-to-host reads per step (the program's ``host_reads``)."),
    "host_busy_ms_per_step": (
        _host_busy,
        "Host ms per step inside ``NS_Step`` less the ``host_read`` spans: the host's own "
        "work of enqueueing the step. Above the card's busy ms a step, the host paces it."),
}


def values(p: Passes) -> dict:
    return {name: fn(p) for name, (fn, _) in METRICS.items()}


def main(argv=None) -> int:
    """``python3 -m benchmark.spans --workload <cell> --seed <n> [--device
    cuda|cpu]`` from the root of a checkout: the passes in this process;
    prints {"values", "record"} as one JSON line last (null where the
    program has no spans)."""
    import argparse

    import torch

    from benchmark.harness import load_cell
    from fluca_tpu_torch.ops import cuda_stencil

    ap = argparse.ArgumentParser(description="The program's span passes of one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    torch.set_num_threads(4)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        cuda_stencil.load_library()
    p = run_passes(cell, args.seed, device)
    print(json.dumps(None if p is None else {"values": values(p), "record": record(p)}),
          flush=True)
    return 0


def passes(run) -> dict | None:
    """{"values", "record"} of the passes for ``run``'s cell, made once a
    traced run in a process of their own (no profiler ran there before
    pass B, and the harness's traced steps and reference leave nothing
    behind in it), from the run's seed; None for an untraced run or a
    program without spans. Prints the record on standard error."""
    if run.trace is None:
        return None
    if not hasattr(run, PASSES_ATTR):
        out = None
        if _profiling() is not None:
            r = subprocess.run([sys.executable, "-m", "benchmark.spans", "--workload",
                                run.cell.name, "--seed", str(run_seed()), "--device", run.device],
                               cwd=run.cell.root, capture_output=True, text=True, timeout=1200)
            if r.returncode != 0:
                raise RuntimeError(f"the span passes failed (exit {r.returncode}): "
                                   f"{r.stderr[-3000:]}")
            out = json.loads(r.stdout.strip().splitlines()[-1])
        if out is not None:
            rec = dict(out["record"], window_step_ms_median=(
                statistics.median(run.step_s) * 1e3 if run.step_s else None))
            print("spans: " + json.dumps(rec), file=sys.stderr, flush=True)
        setattr(run, PASSES_ATTR, out)
    return getattr(run, PASSES_ATTR)


def _reader(name: str):
    def read(run):
        out = passes(run)
        return None if out is None else out["values"][name]
    read.__name__, read.__doc__ = name, METRICS[name][1]
    return read


# -- the readers ----------------------------------------------------------------
krylov_ms_per_step = _reader("krylov_ms_per_step")
momentum_ms_per_step = _reader("momentum_ms_per_step")
schur_ms_per_step = _reader("schur_ms_per_step")
ibm_ms_per_step = _reader("ibm_ms_per_step")
roofline_pct_chain3d = _reader("roofline_pct_chain3d")
host_reads_per_step = _reader("host_reads_per_step")
host_busy_ms_per_step = _reader("host_busy_ms_per_step")

if __name__ == "__main__":
    sys.exit(main())
