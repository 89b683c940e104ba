"""Regularized delta kernels for the immersed boundary method
(counterpart of fluca_tpu.ibm.delta).

Kernels (1-D; the dim-D delta is the tensor product / h^dim):
  roma3   — 3-point kernel of Roma, Peskin & Berger (1999)
  peskin4 — classic 4-point cosine-smooth kernel of Peskin (2002)
Each takes a tensor of offsets r in cell widths and evaluates the
reference's expression in the same order.
"""

from __future__ import annotations

import torch


def delta_roma3(r):
    """phi(r) with support |r| <= 1.5 (r in cell widths)."""
    a = torch.abs(r)
    inner = (1.0 + torch.sqrt(torch.clamp(1.0 - 3.0 * a * a, min=0.0))) / 3.0
    outer = (
        5.0 - 3.0 * a
        - torch.sqrt(torch.clamp(-3.0 * (1.0 - a) ** 2 + 1.0, min=0.0))
    ) / 6.0
    zero = torch.zeros_like(a)
    return torch.where(a <= 0.5, inner, torch.where(a <= 1.5, outer, zero))


def delta_peskin4(r):
    """phi(r) with support |r| <= 2."""
    a = torch.abs(r)
    inner = (3.0 - 2.0 * a + torch.sqrt(
        torch.clamp(1.0 + 4.0 * a - 4.0 * a * a, min=0.0))) / 8.0
    outer = (5.0 - 2.0 * a - torch.sqrt(
        torch.clamp(-7.0 + 12.0 * a - 4.0 * a * a, min=0.0))) / 8.0
    zero = torch.zeros_like(a)
    return torch.where(a <= 1.0, inner, torch.where(a <= 2.0, outer, zero))


KERNELS = {
    "roma3": (delta_roma3, 3),  # (function, support width in cells)
    "peskin4": (delta_peskin4, 4),
}
