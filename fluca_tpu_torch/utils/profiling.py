"""Spans and counters of the step: the port's one tracing system.

Reference: PETSc log events MESH_SetUp, NS_SetUp, NS_Step,
NS_FormJacobian, NS_FormFunction + -log_view (fluca/src/ns/interface/
nspkg.c:21-34).

``span(name)`` marks a layer boundary of the step and ``count(name, n)``
a counter; ``read(x, site)`` is a device-to-host read of a tensor. All
three do nothing while tracing is off (the default): ``span`` returns one
shared no-op object after a single module-global check, records nothing,
allocates nothing and reads nothing from the device.

Tracing is on inside ``tracing()`` (or between ``start()`` and
``stop()``). A span then keeps its name, its parent span, the step index
(the count of ``NS_Step`` spans begun, -1 before the first) and its host
start and end from ``time.perf_counter_ns``; under a running
``torch.profiler`` it also opens ``record_function(name)``, so that the
range sits in the trace on the profiler's clock, beside the kernels it
launched. No span synchronises: a span's host time is the time the host
spent enqueueing its work, except where a ``host_read`` inside it waited
for the card. The log gives each span name's count, host ms and self host
ms (the duration less its children's), and the counters; ``view`` is the
``-log_view`` table.

Span names (``NS_Step`` the root of each step): ``NS_SetUp``,
``step.rhs`` (with ``ibm.force`` inside), ``step.coeffs``, ``step.outer``
(``outer.apply``, and ``abf`` with ``abf.momentum``, ``abf.pre``,
``abf.schur`` (``mg.vcycle``, ``mg.coarse``) and ``abf.post``),
``step.project``, ``host_read``, and on the rank path ``exchange`` and
``collective``. Counters: ``host_reads`` and ``host_reads.<site>``,
``iters.outer``, ``iters.momentum``, ``iters.schur``, and the stencil
kernels' launches on the card (``count_launches``, at the launch site):
``launches.<kernel>.<mode>.<shape>.<instance>``, the mode of a Poisson
kernel (apply, residual, smooth) or ``-``, the shape of the launch's
ledger key with its extents joined by ``x`` (a halo launch's global,
block and grid shapes joined by ``_``), the instance ``f32``, ``f64`` or
``bf16``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

ROOT = "NS_Step"
HOST_READ = "host_read"
LAUNCHES = "launches"

# the running log; None while tracing is off
_log = None


class _Off:
    """The span of a log that is off: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One span of a running log (``span``)."""

    __slots__ = ("log", "name", "index", "rf")

    def __init__(self, log: "SpanLog", name: str):
        self.log, self.name = log, name

    def __enter__(self):
        log = self.log
        if self.name == ROOT:
            log.step += 1
        self.index = len(log.records)
        log.records.append([self.name, log.stack[-1] if log.stack else -1, log.step,
                            time.perf_counter_ns(), None])
        log.stack.append(self.index)
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        log = self.log
        log.records[self.index][4] = time.perf_counter_ns()
        log.stack.pop()
        return False


class SpanLog:
    """What a running log kept: ``records`` [name, parent index (-1 for
    none), step index, start ns, end ns (None while open)] in the order
    the spans began, and ``counters``."""

    def __init__(self):
        self.records = []
        self.counters = defaultdict(int)
        self.stack = []
        self.step = -1

    @property
    def steps(self) -> int:
        """The ``NS_Step`` spans begun."""
        return self.step + 1

    def summary(self) -> dict:
        """{span name: {"count", "ms", "self_ms"}} of the closed spans, in
        the order the names first appeared: host ms in all, and less the
        children's."""
        dur = [0 if r[4] is None else r[4] - r[3] for r in self.records]
        child = [0] * len(dur)
        for r, d in zip(self.records, dur):
            if r[1] >= 0:
                child[r[1]] += d
        out = {}
        for r, d, c in zip(self.records, dur, child):
            if r[4] is None:
                continue
            s = out.setdefault(r[0], {"count": 0, "ms": 0.0, "self_ms": 0.0})
            s["count"] += 1
            s["ms"] += d * 1e-6
            s["self_ms"] += (d - c) * 1e-6
        return out

    def view(self) -> str:
        """The ``-log_view`` table: every span name (count, host ms, self
        host ms, ms per call) and every counter."""
        lines = [f"{'Span':24s} {'Count':>8s} {'Time (ms)':>12s} {'Self (ms)':>12s} "
                 f"{'Avg (ms)':>10s}"]
        for name, s in self.summary().items():
            lines.append(f"{name:24s} {s['count']:8d} {s['ms']:12.3f} {s['self_ms']:12.3f} "
                         f"{s['ms'] / s['count']:10.3f}")
        lines.append(f"{'Counter':24s} {'Count':>8s}")
        for name in sorted(self.counters):
            lines.append(f"{name:24s} {self.counters[name]:8d}")
        return "\n".join(lines)


def span(name: str):
    """A context manager around one layer of the step; the shared no-op
    while tracing is off."""
    log = _log
    if log is None:
        return _OFF
    return _Span(log, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    log = _log
    if log is not None:
        log.counters[name] += n


def _extents(shape) -> str:
    if shape and isinstance(shape[0], tuple):
        return "_".join(map(_extents, shape))
    return "x".join(map(str, shape))


def launch_counter(kernel: str, mode, shape, instance: str) -> str:
    """The counter name of a stencil kernel's launches (``count_launches``)."""
    return f"{LAUNCHES}.{kernel}.{mode or '-'}.{_extents(shape)}.{instance}"


def count_launches(kernel: str, mode, shape, instance: str) -> None:
    """Count one launch of ``kernel`` (in ``mode``, None for a kernel
    without one) at ``shape`` in ``instance`` while tracing is on; the
    name is built only then."""
    log = _log
    if log is not None:
        log.counters[launch_counter(kernel, mode, shape, instance)] += 1


def read(x, site: str, convert=float):
    """``convert(x)`` of the tensor ``x``: a read back to the host, which
    on the card waits for the queue to drain. While tracing is on it is
    counted in ``host_reads`` and ``host_reads.<site>`` and spanned as
    ``host_read``."""
    log = _log
    if log is None:
        return convert(x)
    log.counters["host_reads"] += 1
    log.counters[f"host_reads.{site}"] += 1
    with _Span(log, HOST_READ):
        return convert(x)


def current():
    """The running log, or None."""
    return _log


def start() -> SpanLog:
    """Turn tracing on; returns the new log."""
    global _log
    if _log is not None:
        raise RuntimeError("tracing is already on")
    _log = SpanLog()
    return _log


def stop() -> SpanLog:
    """Turn tracing off; returns the log it kept."""
    global _log
    if _log is None:
        raise RuntimeError("tracing is off")
    log, _log = _log, None
    return log


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block; yields the log."""
    log = start()
    try:
        yield log
    finally:
        stop()
