"""NS state between numpy and torch.

The state dict {"v": tuple, "U": tuple, "p", "phalf"} is what weights
are to a model. These helpers carry a state held as numpy arrays (for
instance one taken from the JAX package mid-run) onto a device and
back, so two implementations can continue from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

_TUPLE_FIELDS = ("v", "U")
_FIELDS = ("v", "U", "p", "phalf")


def state_from_numpy(state_np, device, dtype) -> dict:
    """A torch state from numpy arrays; every leaf is a new tensor (no
    two leaves share storage)."""

    def leaf(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    out = {}
    for k in _FIELDS:
        if k in _TUPLE_FIELDS:
            out[k] = tuple(leaf(a) for a in state_np[k])
        else:
            out[k] = leaf(state_np[k])
    return out


def state_to_numpy(state) -> dict:
    """numpy copies of a torch state."""

    def leaf(t):
        return t.detach().cpu().numpy().copy()

    out = {}
    for k in _FIELDS:
        if k in _TUPLE_FIELDS:
            out[k] = tuple(leaf(t) for t in state[k])
        else:
            out[k] = leaf(state[k])
    return out
