"""NS monitors (reference: fluca/src/ns/interface/nsmon.c).

Monitors are callables ``fn(ns)`` invoked before every step and once
after the final step (nsbasic.c:336-345). Built-ins mirror
NSMonitorDefault (step/dt/time line, nsmon.c:47-70) and
NSMonitorSolution (solution write every ``interval`` steps,
nsmon.c:72-99), wired from options -ns_monitor /
-ns_monitor_solution[_interval] (nsopts.c:190-194).
"""

from __future__ import annotations


def monitor_default(ns) -> None:
    extra = ""
    if ns.last_diag is not None:
        extra = f"  ksp_its={int(ns.last_diag['ksp_iters'])}"
    print(f"step {ns.step_index}  dt {ns.dt:g}  time {ns.t:g}{extra}")


def make_solution_monitor(writer, interval: int = 1):
    """Write the solution every ``interval`` steps through any object
    with write_solution(ns)."""

    def monitor(ns) -> None:
        if ns.step_index % interval == 0:
            writer.write_solution(ns)

    return monitor


def set_monitors_from_options(ns, opts, writer_factory=None) -> None:
    o = opts.sub("ns_")
    if o.get_bool("monitor"):
        ns.add_monitor(monitor_default)
    if o.get_bool("monitor_solution") and writer_factory is not None:
        interval = o.get_int("monitor_solution_interval", 1)
        ns.add_monitor(make_solution_monitor(writer_factory(), interval))
    # cadence of the monitor chain inside advance() batches
    if o.has("monitor_interval"):
        ns.monitor_interval = o.get_int("monitor_interval")
