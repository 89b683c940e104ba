"""Host-side event timing.

Reference: PETSc log events MESH_SetUp, NS_SetUp, NS_Step,
NS_FormJacobian, NS_FormFunction + -log_view (fluca/src/ns/interface/
nspkg.c:21-34). Wall-clock event accumulation printable as a
-log_view-style table. The times are host times: CUDA work is
asynchronous, so an event measures device time only where its scope
ends in a synchronisation (``NS_Step`` does, through its converged
check).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class EventLog:
    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def event(self, name: str):
        """Host-side timed scope."""
        t0 = time.perf_counter()
        yield
        self.times[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def view(self) -> str:
        """-log_view-style summary table."""
        lines = [f"{'Event':24s} {'Count':>8s} {'Time (s)':>12s} "
                 f"{'Avg (ms)':>10s}"]
        for name in sorted(self.times):
            t, n = self.times[name], self.counts[name]
            lines.append(
                f"{name:24s} {n:8d} {t:12.4f} {1e3 * t / max(n, 1):10.2f}"
            )
        return "\n".join(lines)


global_log = EventLog()
