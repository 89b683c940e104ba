"""The traced steps of a ``--trace 1`` run: ``torch.profiler`` over a few
whole steps after the window, reduced to device intervals, kernel times
by name, the host activity under each idle gap, and the stencil calls
that a recorder around the port's kernel wrappers saw.

A device event is any activity the profiler puts on the card's
timeline: kernels, copies and fills. A launch is a kernel. The traced
span runs from the start of the first step's host range to the end of
the last one's; each step ends in its own host read, so the card has
drained by then.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field
from pathlib import Path

STEP_LABEL = "benchmark.step"
# device activity that is no kernel launch
_NOT_KERNEL = ("Memcpy", "Memset")
# host events that are no torch operation: CUDA runtime calls and the
# profiler's own
_NOT_OPS = ("cuda", "cu", "Activity Buffer", STEP_LABEL)
# ``__launch_bounds__(...)``, with up to two levels of parentheses inside
_LAUNCH_BOUNDS = r"__launch_bounds__\s*\((?:[^()]|\((?:[^()]|\([^()]*\))*\))*\)"


def port_kernel_names(csrc: Path) -> frozenset:
    """The identifiers of the ``__global__`` functions in the port's CUDA
    sources: what a kernel name in the trace is matched against."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        text = re.sub(_LAUNCH_BOUNDS, "", path.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return frozenset(names)


def matches(kernel_name: str, ident: str) -> bool:
    return re.search(rf"\b{re.escape(ident)}\b", kernel_name) is not None


class Recorder:
    """Records (op, mode, shape, periodic, dtype) of every call of the
    port's 3-D Poisson and momentum kernel wrappers while it is entered,
    by wrapping the wrappers' classes."""

    def __init__(self):
        self.calls = []
        self._saved = []

    def __enter__(self):
        from fluca_tpu_torch.ops import cuda_stencil as cs

        def poisson(orig):
            def call(obj, mode, p, c, *a, **k):
                self.calls.append(("poisson3d", mode, tuple(p.shape), tuple(c.periodic),
                                   str(p.dtype).removeprefix("torch.")))
                return orig(obj, mode, p, c, *a, **k)
            return call

        def momentum(orig):
            def call(obj, bands, f, v, *a, **k):
                self.calls.append(("momentum3d", None, tuple(v[0].shape), tuple(bands.periodic),
                                   str(v[0].dtype).removeprefix("torch.")))
                return orig(obj, bands, f, v, *a, **k)
            return call

        for cls, wrap in ((cs.Poisson3DKernel, poisson), (cs.Momentum3DKernel, momentum)):
            orig = cls.__call__
            self._saved.append((cls, orig))
            cls.__call__ = wrap(orig)
        return self

    def __exit__(self, *exc):
        for cls, orig in self._saved:
            cls.__call__ = orig
        self._saved.clear()
        return False


@dataclass
class Trace:
    """What the metric readers read: ``steps`` whole steps traced over
    ``span`` (start, end) in microseconds; ``device`` (name, start, end)
    events; ``kernels`` the launches among them; ``host`` (name, start,
    end) events of the host; ``calls`` the recorder's calls."""

    steps: int
    span: tuple
    device: list
    kernels: list
    host: list
    port_kernels: frozenset
    calls: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-6

    def busy_intervals(self):
        """The device events clipped to the span and merged."""
        lo, hi = self.span
        out = []
        for _, s, e in sorted((ev for ev in self.device), key=lambda ev: ev[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, pred=lambda name: True) -> float:
        return sum(e - s for name, s, e in self.kernels if pred(name)) * 1e-6

    def device_ops(self, top=10):
        """[name, seconds] of the device events that took most time."""
        tot = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[host activity, seconds] of the idle gaps in the span, each gap
        named by the innermost torch operation running on the host at its
        middle ("(between torch ops)" where none runs: the Python of the
        step), summed by name."""
        gaps, t = [], self.span[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.span[1] > t:
            gaps.append((t, self.span[1]))
        ops = sorted((ev for ev in self.host if not ev[0].startswith(_NOT_OPS)),
                     key=lambda ev: ev[1])
        tot, active, i = {}, [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (s + e)
            while i < len(ops) and ops[i][1] <= mid:
                heapq.heappush(active, (-ops[i][1], i))
                i += 1
            while active and ops[active[0][1]][2] < mid:
                heapq.heappop(active)
            name = ops[active[0][1]][0] if active else "(between torch ops)"
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def profile_steps(step, steps: int, csrc: Path) -> Trace:
    """Run ``step()`` ``steps`` times under the profiler and the
    recorder; returns the reduced trace (with no device events where
    torch has no GPU)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = Recorder()
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with rec:
            for _ in range(steps):
                with record_function(STEP_LABEL):
                    step()
        if cuda:
            torch.cuda.synchronize()
    device, host, marks = [], [], []
    for ev in prof.events():
        name = ev.name
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if name != STEP_LABEL:
                device.append((name, s, e))
        elif name == STEP_LABEL:
            marks.append((s, e))
        else:
            host.append((name, s, e))
    if len(marks) != steps:
        raise RuntimeError(f"the trace holds {len(marks)} step ranges, not {steps}")
    span = (min(m[0] for m in marks), max(m[1] for m in marks))
    kernels = [ev for ev in device if not ev[0].startswith(_NOT_KERNEL)]
    return Trace(steps=steps, span=span, device=device, kernels=kernels, host=host,
                 port_kernels=port_kernel_names(csrc), calls=rec.calls)
