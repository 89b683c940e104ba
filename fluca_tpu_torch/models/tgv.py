"""Taylor-Green vortex: the NS solver's analytic correctness oracle.

Reference: fluca/tests/taylor_green_vortex/taylor_green_vortex.c.
  u(x,y,t) =  sin(x) cos(y) exp(-2 nu t)
  v(x,y,t) = -cos(x) sin(y) exp(-2 nu t)
  p(x,y,t) = (rho/4)(cos 2x + cos 2y) exp(-4 nu t)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition
from fluca_tpu_torch.ns.ns import NS


def taylor_green_2d_exact(rho, mu, t, x, y):
    """Exact (u, v, p) at time t (a float) on coordinate tensors x,
    y."""
    nu = mu / rho
    decay = math.exp(-2.0 * nu * t)
    u = torch.sin(x) * torch.cos(y) * decay
    v = -torch.cos(x) * torch.sin(y) * decay
    p = rho / 4.0 * (torch.cos(2 * x) + torch.cos(2 * y)) * decay**2
    return u, v, p


def _grid(a, b, like):
    return torch.meshgrid(
        torch.as_tensor(a, dtype=like.dtype, device=like.device),
        torch.as_tensor(b, dtype=like.dtype, device=like.device),
        indexing="ij",
    )


def setup_taylor_green_2d(
    N=8,
    nsteps=1,
    t_final=1.0,
    rho=1.0,
    mu=1.0,
    periodic=False,
    dtype=None,
    *,
    device,
) -> NS:
    """Build the TGV problem with the analytic initial condition set on
    all three field layouts (taylor_green_vortex.c:97-179)."""
    mesh = CartMesh.create((N, N), (periodic, periodic))
    mesh.set_uniform_coordinates(0.0, 2 * np.pi, 0.0, 2 * np.pi)
    dt = t_final / nsteps

    def velocity(t, xs):
        u, v, _ = taylor_green_2d_exact(rho, mu, t, xs[0], xs[1])
        return (u, v)

    if periodic:
        bc = BoundaryCondition(BCType.PERIODIC)
    else:
        bc = BoundaryCondition(BCType.VELOCITY, velocity=velocity)

    ns = NS(
        mesh, device=device, rho=rho, mu=mu, dt=dt, max_steps=nsteps,
        dtype=dtype, bcs=[bc] * 4,
    )
    ns.setup()

    like = ns.state["p"]
    cx, cy = mesh.centers(0), mesh.centers(1)
    fx, fy = mesh.face_coords(0), mesh.face_coords(1)
    u0, v0, p0 = taylor_green_2d_exact(rho, mu, 0.0, *_grid(cx, cy, like))
    Ux0, _, _ = taylor_green_2d_exact(rho, mu, 0.0, *_grid(fx, cy, like))
    _, Uy0, _ = taylor_green_2d_exact(rho, mu, 0.0, *_grid(cx, fy, like))
    ns.set_solution(v=(u0, v0), U=(Ux0, Uy0), p=p0,
                    phalf=torch.zeros_like(p0))
    return ns


def tgv_errors(ns: NS):
    """L2 (plain 2-norm, matching VecNorm NORM_2 in
    taylor_green_vortex.c:24-35) errors of v and p vs the analytic
    solution at the current time."""
    mesh, rho, mu, t = ns.mesh, ns.rho, ns.mu, ns.t
    u, v = ns.state["v"]
    p = ns.state["p"]
    ue, ve, pe = taylor_green_2d_exact(
        rho, mu, t, *_grid(mesh.centers(0), mesh.centers(1), p)
    )
    v_err = torch.sqrt(torch.sum((u - ue) ** 2) + torch.sum((v - ve) ** 2))
    p_err = torch.sqrt(torch.sum((p - pe) ** 2))
    return float(v_err), float(p_err)
