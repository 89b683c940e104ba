"""TVD flux limiters psi(r) (counterpart of fluca_tpu.ops.limiters).

The reference registers 11 limiters (fluca/src/fd/impls/
secondordertvd/secondordertvdlimiter.c:3-82,
FlucaFDLimiterRegisterAll at secondordertvd.c:19-36). Elementwise torch
forms of the reference's formulas, on any device and dtype.
"""

from __future__ import annotations

import torch

from fluca_tpu_torch.utils.registry import Registry

limiter_registry = Registry("limiter")


def _clamp0(x):
    return torch.clamp(x, min=0.0)


def _superbee(r):
    return _clamp0(torch.maximum(torch.clamp(2.0 * r, max=1.0), torch.clamp(r, max=2.0)))


def _minmod(r):
    return _clamp0(torch.clamp(r, max=1.0))


def _mc(r):
    return _clamp0(torch.clamp(torch.minimum(2.0 * r, (1.0 + r) / 2.0), max=2.0))


def _vanleer(r):
    a = torch.abs(r)
    return (r + a) / (1.0 + a)


def _vanalbada(r):
    return torch.where(r <= 0.0, torch.zeros_like(r), (r * r + r) / (r * r + 1.0))


def _barthjesperson(r):
    a = 4.0 * r / (1.0 + r)
    b = 4.0 / (1.0 + r)
    val = (1.0 + r) / 2.0 * torch.clamp(torch.minimum(a, b), max=1.0)
    return torch.where(r <= 0.0, torch.zeros_like(r), val)


def _venkatakrishnan(r):
    a = 4.0 * r * (3.0 * r + 1.0) / (11.0 * r * r + 4.0 * r + 1.0)
    b = 4.0 * (r + 3.0) / (r * r + 4.0 * r + 11.0)
    val = (1.0 + r) / 2.0 * torch.minimum(a, b)
    return torch.where(r <= 0.0, torch.zeros_like(r), val)


def _upwind(r):
    return torch.zeros_like(r)


def _sou(r):
    return r


def _quick(r):
    return (3.0 + r) / 4.0


def _koren(r):
    return _clamp0(torch.clamp(torch.minimum(2.0 * r, (1.0 + 2.0 * r) / 3.0), max=2.0))


for name, fn in [
    ("superbee", _superbee),
    ("minmod", _minmod),
    ("mc", _mc),
    ("vanleer", _vanleer),
    ("vanalbada", _vanalbada),
    ("barthjesperson", _barthjesperson),
    ("venkatakrishnan", _venkatakrishnan),
    ("upwind", _upwind),
    ("sou", _sou),
    ("quick", _quick),
    ("koren", _koren),
]:
    limiter_registry.register(name, fn)
