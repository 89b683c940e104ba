"""What each metric reads from a run (``harness.Run``): the functions
that the files of ``end_to_end/`` and ``metrics/`` name. Each returns a
number, or None where the run holds nothing to read."""

from __future__ import annotations

import statistics

from benchmark.roofline import roofline_share
from benchmark.trace import matches


# -- end to end (host clock, taken by the harness) ------------------------
def steps_per_s(run):
    """Steps completed over the whole window's time."""
    return run.attempted / run.window_s if run.attempted else None


def step_ms_p95(run):
    """The 95th percentile of every window step's wall time, in ms, from
    the call of ``NS.step`` to its return."""
    if len(run.step_s) < 2:
        return None
    return statistics.quantiles(run.step_s, n=20, method="inclusive")[18] * 1e3


def peak_mem_gib(run):
    """The card's peak allocated memory over set-up and window, in GiB
    (``torch.cuda.max_memory_allocated``, reset at the start of the run)."""
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None


def setup_s(run):
    """Seconds from the start of the process to the first timed step: the
    kernel library's build (on a checkout's first run) or load, the
    program's set-up, the seed's fields and the set-up steps."""
    return run.setup_s


# -- per layer: the traced steps -------------------------------------------
def launches_per_step(run):
    """Kernel launches on the card per step."""
    tr = run.trace
    return len(tr.kernels) / tr.steps if tr is not None and tr.kernels else None


def torch_kernels_ms_per_step(run):
    """Device ms per step of the kernels not built from the port's CUDA
    sources (torch's elementwise and reduction kernels, cuBLAS)."""
    tr = run.trace
    if tr is None or not tr.kernels:
        return None

    def is_torch(name):
        return not any(matches(name, k) for k in tr.port_kernels)

    return tr.kernel_seconds(is_torch) * 1e3 / tr.steps


def device_idle_pct(run):
    """The card's idle share of the window's last steps, in %: one minus
    the device time of the traced steps (the union of their device
    events) over the host-clock time of as many window steps just before
    them. The traced steps' own span would read the profiler: it adds
    host time to every launch, which a host-paced step pays in full."""
    tr = run.trace
    if tr is None or not tr.device or len(run.step_s) < tr.steps:
        return None
    return 100.0 * (1.0 - tr.busy_s / sum(run.step_s[-tr.steps:]))


def roofline_pct_momentum3d(run):
    """The 3-D momentum A-apply (every instance) against its memory
    roofline, in %."""
    return roofline_share(run.trace, "momentum3d", "momentum3d_kernel")


def roofline_pct_poisson3d(run):
    """The 3-D Poisson stencil (every multigrid level, mode and instance)
    against its memory roofline, in %."""
    return roofline_share(run.trace, "poisson3d", "poisson3d_kernel")


# -- per layer: the program's counters over the window ----------------------
def outer_iters_per_step(run):
    """Outer Krylov iterations per step (``NS.last_diag["ksp_iters"]``),
    the mean over the window's steps, where the outer solve stops on a
    tolerance; a fixed budget sets the count itself."""
    if run.cell.traffic["solver"].get("preset") == "production" or not run.ksp_iters:
        return None
    return sum(run.ksp_iters) / len(run.ksp_iters)
