"""Cylinder wake via the IBM (counterpart of fluca_tpu.models.cylinder;
BASELINE.json config #3: the 2-D cylinder wake at Re 100 via IBM
delta-function marker interpolation and spreading)."""

from __future__ import annotations

import torch

from fluca_tpu_torch.ibm.forcing import DirectForcingIBM
from fluca_tpu_torch.ibm.markers import circle_markers
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition
from fluca_tpu_torch.ns.ns import NS


def setup_cylinder_2d(
    N=(128, 64),
    domain=(4.0, 2.0),
    center=(1.0, 1.0),
    diameter=0.2,
    Re=100.0,
    U_in=1.0,
    dt=5e-3,
    max_steps=100,
    kernel="roma3",
    dtype=None,
    *,
    device,
):
    """Uniform inflow (left), pressure outlet (right), symmetry
    top/bottom; a stationary cylinder by direct-forcing IBM, started from
    uniform flow, on ``device``. Re is based on the diameter. Returns
    (ns, ibm)."""
    mesh = CartMesh.create(N)
    mesh.set_uniform_coordinates(0.0, domain[0], 0.0, domain[1])

    rho = 1.0
    mu = rho * U_in * diameter / Re

    inflow = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: (U_in + 0.0 * xs[1], 0.0 * xs[1]),
    )
    outflow = BoundaryCondition(
        BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[1]
    )
    sym = BoundaryCondition(BCType.SYMMETRY)

    ns = NS(
        mesh, device=device, rho=rho, mu=mu, dt=dt, max_steps=max_steps,
        dtype=dtype, bcs=[inflow, outflow, sym, sym],
    )
    ns.setup()

    dt_, dev = ns.impl.dtype, ns.impl.device
    markers = circle_markers(mesh, center, diameter / 2.0, kernel=kernel,
                             dtype=dt_, device=dev)
    ibm = DirectForcingIBM(markers, dt)
    ns.impl.body_force = ibm.body_force

    # uniform flow; every state leaf its own buffer
    ns.set_solution(
        v=(torch.full(mesh.cell_shape, U_in, dtype=dt_, device=dev),
           torch.zeros(mesh.cell_shape, dtype=dt_, device=dev)),
        U=(torch.full(mesh.face_shape(0), U_in, dtype=dt_, device=dev),
           torch.zeros(mesh.face_shape(1), dtype=dt_, device=dev)),
    )
    return ns, ibm


def drag_lift_coefficients(ns, ibm, U_in=1.0, diameter=0.2):
    """C_D, C_L from the IBM reaction force (one host read)."""
    F = ibm.hydrodynamic_force(ns.state, ns.t, ns.rho).to("cpu", torch.float64)
    qD = 0.5 * ns.rho * U_in**2 * diameter
    return float(F[0] / qD), float(F[1] / qD)
