"""Global numeric configuration.

The compute dtype defaults to float32, the card's native width for the
stencil kernels. Verification runs pass ``dtype=torch.float64``
explicitly. bfloat16 is the reduced-precision ABF preconditioner's
dtype (``CNLinearConfig.precond_dtype``), not a solver dtype. There is
no device default: every constructor that makes tensors takes its
device as an argument.
"""

from __future__ import annotations

import torch

_DTYPE_NAMES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "float64": torch.float64,
    "f64": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}

_default_dtype = torch.float32


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name, or None (the
    default)."""
    if dtype is None:
        return _default_dtype
    if isinstance(dtype, str):
        return _DTYPE_NAMES[dtype]
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a torch dtype: {dtype!r}")
    return dtype


def default_dtype() -> torch.dtype:
    """Compute dtype for field data and stencil coefficients."""
    return _default_dtype


def set_default_dtype(dtype) -> None:
    global _default_dtype
    _default_dtype = resolve_dtype(dtype)
