"""Backward-facing step (sudden expansion) flow (counterpart of
fluca_tpu.models.bfs).

The classic separated-flow benchmark (Armaly et al. 1983; Gartling
1990): a parabolic inlet over the upper half of the channel, a solid
step face over the lower half at the inlet plane (the Gartling
formulation: the step is not resolved upstream), no-slip walls, and a
pressure outlet. The validation quantity is the lower-wall reattachment
length x_r of the recirculation bubble behind the step.

Conventions: channel height H = 1, step height S = H/2, inlet height
h = H/2 occupying y in [S, H]; mean inlet velocity u_mean = 1 so the
parabolic profile is u(y) = 6 u_mean (y-S)(H-y)/h^2 with peak
1.5 u_mean; Re = rho u_mean D_h / mu with hydraulic diameter
D_h = 2h = H = 1. Literature lower-wall reattachment for expansion
ratio 2: x_r/S ~= 3.0 at Re=100 (Armaly et al. exp. ~3.0; 2-D
computations 2.8-3.1), x_r/S ~= 12.2 at Re=800 (Gartling).
"""

from __future__ import annotations

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import NS


def setup_bfs_2d(
    N=(512, 64),
    L=10.0,
    Re=100.0,
    u_mean=1.0,
    dt=0.01,
    max_steps=10000,
    dtype=None,
    *,
    device,
    **ns_kwargs,
) -> NS:
    """Backward-facing step, expansion ratio 2 (H=1, S=0.5), on
    ``device``, started from rest."""
    H, S = 1.0, 0.5
    h = H - S
    rho = 1.0
    mu = rho * u_mean * (2.0 * h) / Re

    mesh = CartMesh.create(N)
    mesh.set_uniform_coordinates(0.0, L, 0.0, H)

    def inlet_profile(y):
        u = 6.0 * u_mean * (y - S) * (H - y) / h**2
        return torch.where(y > S, u, 0.0 * y)

    inflow = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: (inlet_profile(xs[1]) + 0.0 * xs[0], 0.0 * xs[1]),
    )
    outflow = BoundaryCondition(
        BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[1]
    )
    wall = zero_velocity_bc()

    ns = NS(
        mesh, device=device, rho=rho, mu=mu, dt=dt, max_steps=max_steps,
        dtype=dtype, bcs=[inflow, outflow, wall, wall], **ns_kwargs,
    )
    ns.setup()
    return ns


def reattachment_length(ns: NS) -> float:
    """Lower-wall reattachment x_r: the last downstream zero crossing
    (negative -> positive) of the near-wall streamwise velocity behind
    the step, linearly interpolated between cell centers. Near-wall u is
    proportional to wall shear for the first cell row, so its sign change
    is the reattachment point."""
    u = ns.state["v"][0][:, 0].to("cpu", torch.float64).numpy()
    x = np.asarray(ns.mesh.centers(0))
    neg = u < 0.0
    if not np.any(neg):
        return 0.0
    i_last = int(np.max(np.nonzero(neg)))
    if i_last + 1 >= len(u):
        return float(x[-1])  # bubble reaches the outlet
    u0, u1 = u[i_last], u[i_last + 1]
    x0, x1 = x[i_last], x[i_last + 1]
    return float(x0 + (0.0 - u0) / (u1 - u0) * (x1 - x0))
