"""NS state and FD operators between numpy and torch.

The state dict {"v": tuple, "U": tuple, "p", "phalf"} is what weights
are to a model. These helpers carry a state held as numpy arrays (for
instance one taken from the JAX package mid-run) onto a device and
back, so two implementations can continue from the same state, and cut
a whole state into one rank's block (``cut_state``), so that every rank
of a rank-held grid starts from it. An FD
operator carries across as its host bands (``stencil_op_from_numpy``),
so two implementations can apply the same operator.
"""

from __future__ import annotations

import numpy as np
import torch

from fluca_tpu_torch.ops.fd import StencilOp

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


def cut_state(state, block) -> dict:
    """This rank's block (``parallel.mesh.Block``) of a whole state, numpy
    or torch (for instance from the JAX package or a one-process run): the
    cells of v, p and phalf, and the faces of each U[d] lo + hilast. Each
    leaf is a new contiguous array or tensor on the input's device."""

    def leaf(x, face=None):
        x = block.cut(x, face)
        return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)

    return {
        "v": tuple(leaf(x) for x in state["v"]),
        "U": tuple(leaf(x, d) for d, x in enumerate(state["U"])),
        "p": leaf(state["p"]),
        "phalf": leaf(state["phalf"]),
    }


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


def stencil_op_from_numpy(mesh, bands, const, in_stag, out_stag, device, dtype):
    """A port StencilOp (fluca_tpu_torch.ops.fd) on ``mesh`` from an
    operator's bands held as numpy arrays ({offset tuple: array of the
    output shape}, for instance a fluca_tpu operator's ``np.asarray``'d
    bands) and its constant; the bands are kept in float64 on the host
    and moved once to ``device`` in ``dtype``. ``mesh`` is the port's
    mesh of the same grid."""
    op = StencilOp(mesh, tuple(bool(s) for s in in_stag), tuple(bool(s) for s in out_stag),
                   {tuple(int(o) for o in off): np.array(w, dtype=np.float64)
                    for off, w in bands.items()},
                   np.array(const, dtype=np.float64))
    op.device_arrays(device, dtype)
    return op
