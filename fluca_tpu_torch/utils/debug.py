"""Debug / sanity checking (counterpart of fluca_tpu.utils.debug).

The reference relies on PETSc debug-mode argument checking and
NSCheckDiverged (nsbasic.c:425-436). Here: field-level finiteness
checks, the continuity residual, and torch's anomaly detection.
"""

from __future__ import annotations

import torch


def _leaves(state):
    """(path, tensor) of every field of an NS state."""
    for key in ("v", "U", "p", "phalf"):
        x = state[key]
        if isinstance(x, (tuple, list)):
            for i, t in enumerate(x):
                yield f"{key}[{i}]", t
        else:
            yield key, x


def _bad(state):
    """The fields holding a non-finite value, after one host read."""
    leaves = list(_leaves(state))
    flags = torch.stack([torch.isfinite(t).all() for _, t in leaves]).cpu()
    return [path for (path, _), ok in zip(leaves, flags.tolist()) if not ok]


def state_finite(state) -> bool:
    """True iff every field in the NS state is finite."""
    return not _bad(state)


def check_state_finite(state, where: str = "") -> None:
    bad = _bad(state)
    if bad:
        raise FloatingPointError(
            f"non-finite fields {bad} {('at ' + where) if where else ''}"
        )


def continuity_residual(ns) -> float:
    """max |D U|: the discrete continuity violation."""
    div = ns.impl.ops.apply_D(ns.state["U"])
    return float(div.abs().max())


def enable_nan_checks(on: bool = True) -> None:
    """The counterpart of jax_debug_nans: torch's anomaly detection,
    which raises where a backward pass produces NaN. The solver runs no
    backward pass, so for its own fields use ``monitor_check_finite``."""
    torch.autograd.set_detect_anomaly(on)


def monitor_check_finite(ns) -> None:
    """Monitor hook: raise on non-finite state (add with
    ns.add_monitor)."""
    check_state_finite(ns.state, where=f"step {ns.step_index}")
