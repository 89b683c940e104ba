"""The comparison that decides ``correct``: the program's state after a
step against the plain reference's step from the same input, leaf by
leaf.

A state is {"v": (u, v[, w]), "U": (Ux, Uy[, Uz]), "p": p, "phalf":
phalf}, in two or three dimensions. Two numbers are compared, both in
float64:

- the worst velocity leaf (v and U): ||program - reference|| over the
  largest velocity leaf's norm in the reference, the flow's scale;
- the worst pressure leaf (p and phalf): ||program - reference|| over
  the larger of the largest pressure leaf's norm and the norm of a
  uniform dynamic pressure u_rms^2 (rho = 1, u_rms from that velocity
  leaf).

Each leaf is measured against its group's scale and not its own norm,
because the rounding of a step is set by the flow's magnitude: a leaf
that decays (the cross-stream velocities and the pressure of a channel
as its start-up noise dies) keeps the same absolute rounding, and
against its own norm it would read larger the further a run got. The
pressure has a number of its own: a fixed CG budget amplifies the
rounding of the predictor's divergence into it by an amount that swings
from seed to seed.
"""

from __future__ import annotations

import math

import torch


def leaves(state) -> dict:
    """{"v0", "v1", ..., "U0", ..., "p", "phalf"}: the state's fields by
    name, as many velocity components as the state has."""
    out = {f"v{c}": x for c, x in enumerate(state["v"])}
    out.update({f"U{d}": x for d, x in enumerate(state["U"])})
    out["p"], out["phalf"] = state["p"], state["phalf"]
    return out


def is_velocity(name: str) -> bool:
    return name[0] in "vU"


def to_host(state):
    """A copy of ``state`` in host memory."""
    return {k: (tuple(x.detach().to("cpu", copy=True) for x in v) if isinstance(v, tuple)
                else v.detach().to("cpu", copy=True)) for k, v in state.items()}


def to_device(state, dtype, device):
    return {k: (tuple(x.to(device=device, dtype=dtype) for x in v) if isinstance(v, tuple)
                else v.to(device=device, dtype=dtype)) for k, v in state.items()}


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gaps(program, reference) -> dict:
    """{leaf: gap} of two states; ``program`` is moved to the reference's
    device and dtype leaf by leaf."""
    ref, prog = leaves(reference), leaves(program)
    norms = {k: norm(x) for k, x in ref.items()}
    vel = max((k for k in ref if is_velocity(k)), key=lambda k: norms[k])
    scale_v = norms[vel]
    dyn = scale_v**2 / math.sqrt(ref[vel].numel())
    scale_p = max(max(n for k, n in norms.items() if not is_velocity(k)), dyn)
    out = {}
    for k, r in ref.items():
        diff = norm(prog[k].to(device=r.device, dtype=torch.float64) - r.double())
        scale = scale_v if is_velocity(k) else scale_p
        out[k] = diff / scale if scale > 0 else diff
    return out


def worst(gaps: dict, names) -> float:
    """The worst gap among the leaves ``names``; infinite where one is
    not a number."""
    vals = [gaps[k] for k in names]
    return max(vals) if all(math.isfinite(g) for g in vals) else math.inf


def state_gaps(program, reference) -> dict:
    """{"vel": worst velocity leaf, "p": worst pressure leaf, "leaves":
    every leaf's gap}."""
    g = leaf_gaps(program, reference)
    return {"vel": worst(g, [k for k in g if is_velocity(k)]),
            "p": worst(g, [k for k in g if not is_velocity(k)]), "leaves": g}


def finite(state) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in leaves(state).values())
