"""The bytes of the 2-D stencils (poisson2d, momentum2d), counted as
``roofline.py`` counts the 3-D ones: each input read once and each output
written once, at the call's shape and dtype, whatever implements it; and
their shares of the memory roofline over a traced run.

A share is the bound time per step of the kernel's launches, each at
its mode, shape and instance as the program's launch counter
(``launches.<kernel>.<mode>.<shape>.<instance>``, pass B's
``counters_per_step`` in ``spans.passes``) has them, over the device ms
per step of the kernels of its family in the traced steps (pass A). Both
passes start from the run's seed and take the same launches a step under
a fixed budget. A program without the counter gives no share."""

from __future__ import annotations

import math

from benchmark import spans
from benchmark.roofline import ITEMSIZE, POISSON_FIELDS, bound_seconds, coef_itemsize
from benchmark.trace import matches

# the momentum 2-D kernel's cell fields: the plane stack W (26 planes in
# the fields' dtype), u and v in, A u and A v out
MOMENTUM2D_FIELDS = 26 + 2 + 2
# the launch counter's instance suffixes
INSTANCES = {"f32": "float32", "f64": "float64", "bf16": "bfloat16"}
# the counted wrapper and the kernel family of its launches in the trace
FAMILIES = {"poisson2d": "poisson2d_kernel", "momentum2d": "momentum2d_kernel"}


def poisson2d_bytes(mode: str, shape, dtype: str) -> int:
    """Shat p on one multigrid level of ``shape``: the mode's cell fields,
    and the coefficient arrays RX (3, N0), RY (N0), CY (N1), CYb (3, N1)."""
    return (POISSON_FIELDS[mode] * math.prod(shape) * ITEMSIZE[dtype]
            + 4 * sum(shape) * coef_itemsize(dtype))


def momentum2d_bytes(shape, dtype: str) -> int:
    """A (u, v) from the plane stack: MOMENTUM2D_FIELDS cell fields."""
    return MOMENTUM2D_FIELDS * math.prod(shape) * ITEMSIZE[dtype]


def launch_key(counter: str):
    """(kernel, mode or None, shape, dtype) of a launch counter's name;
    None for any other counter."""
    parts = counter.split(".")
    if len(parts) != 5 or parts[0] != "launches" or parts[4] not in INSTANCES:
        return None
    _, kernel, mode, shape, sfx = parts
    extents = shape.split("x")
    if not all(n.isdigit() for n in extents):
        return None
    return kernel, None if mode == "-" else mode, tuple(map(int, extents)), INSTANCES[sfx]


def launch_bytes(kernel: str, mode, shape, dtype: str) -> int:
    if kernel == "poisson2d":
        return poisson2d_bytes(mode, shape, dtype)
    if kernel == "momentum2d":
        return momentum2d_bytes(shape, dtype)
    raise ValueError(f"no count for {kernel!r}")


def bound_ms_per_step(counters: dict, kernel: str):
    """The bound ms per step of ``kernel``'s launches in ``counters``
    (launches per step by counter name); None where none was counted."""
    keys = [(launch_key(name), n) for name, n in counters.items()]
    mine = [(key, n) for key, n in keys if key is not None and key[0] == kernel and n]
    if not mine:
        return None
    return sum(n * bound_seconds(launch_bytes(*key)) for key, n in mine) * 1e3


def roofline_share(run, kernel: str):
    """The share in % of its roofline of ``kernel`` over a traced run;
    None where the trace holds no kernel of its family or the program no
    launch counter of it."""
    from benchmark import spans

    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    ms = tr.kernel_seconds(lambda name: matches(name, FAMILIES[kernel])) * 1e3 / tr.steps
    if ms <= 0:
        return None
    out = spans.passes(run)
    if out is None:
        return None
    bound = bound_ms_per_step(out["record"].get("counters_per_step", {}), kernel)
    return None if bound is None else 100.0 * bound / ms


def roofline_pct_poisson2d(run):
    """The 2-D Poisson stencil (every multigrid level, mode and instance)
    against its memory roofline, in %."""
    return roofline_share(run, "poisson2d")


def roofline_pct_momentum2d(run):
    """The 2-D momentum A-apply (every instance) against its memory
    roofline, in %."""
    return roofline_share(run, "momentum2d")
