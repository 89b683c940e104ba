"""3-D flow past a sphere via the IBM (counterpart of
fluca_tpu.models.sphere; BASELINE.json config #4: the sphere at 128^3,
multigrid-preconditioned Poisson, CGNS checkpoint I/O)."""

from __future__ import annotations

import math

import torch

from fluca_tpu_torch.ibm.forcing import DirectForcingIBM
from fluca_tpu_torch.ibm.markers import sphere_markers
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition
from fluca_tpu_torch.ns.ns import NS


def setup_sphere_3d(
    N=(64, 32, 32),
    domain=(4.0, 2.0, 2.0),
    center=(1.0, 1.0, 1.0),
    diameter=0.4,
    Re=100.0,
    U_in=1.0,
    dt=1e-2,
    max_steps=50,
    kernel="roma3",
    dtype=None,
    retract=0.0,
    *,
    device,
):
    """Uniform inflow (-x), pressure outlet (+x), symmetry on the four
    lateral planes; a stationary sphere by direct-forcing IBM with its
    markers ``retract`` cell widths inside the surface, started from
    uniform flow, on ``device``. Returns (ns, ibm)."""
    mesh = CartMesh.create(N)
    mesh.set_uniform_coordinates(0.0, domain[0], 0.0, domain[1], 0.0, domain[2])
    rho = 1.0
    mu = rho * U_in * diameter / Re

    inflow = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: (U_in + 0.0 * xs[1], 0.0 * xs[1], 0.0 * xs[1]),
    )
    outflow = BoundaryCondition(
        BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[1]
    )
    sym = BoundaryCondition(BCType.SYMMETRY)

    ns = NS(
        mesh, device=device, rho=rho, mu=mu, dt=dt, max_steps=max_steps,
        dtype=dtype, bcs=[inflow, outflow, sym, sym, sym, sym],
    )
    ns.setup()

    dt_, dev = ns.impl.dtype, ns.impl.device
    markers = sphere_markers(mesh, center, diameter / 2.0, kernel=kernel,
                             dtype=dt_, retract=retract, device=dev)
    ibm = DirectForcingIBM(markers, dt)
    ns.impl.body_force = ibm.body_force

    # uniform flow; every state leaf its own buffer
    ns.set_solution(
        v=(torch.full(mesh.cell_shape, U_in, dtype=dt_, device=dev),
           torch.zeros(mesh.cell_shape, dtype=dt_, device=dev),
           torch.zeros(mesh.cell_shape, dtype=dt_, device=dev)),
        U=(torch.full(mesh.face_shape(0), U_in, dtype=dt_, device=dev),
           torch.zeros(mesh.face_shape(1), dtype=dt_, device=dev),
           torch.zeros(mesh.face_shape(2), dtype=dt_, device=dev)),
    )
    return ns, ibm


def drag_coefficient(ns, ibm, U_in=1.0, diameter=0.4):
    """C_D from the IBM reaction force over the frontal area (one host
    read), as examples/sphere_drag.py and tests/test_sphere.py take it."""
    F = ibm.hydrodynamic_force(ns.state, ns.t, ns.rho).to("cpu", torch.float64)
    qA = 0.5 * ns.rho * U_in**2 * (math.pi * diameter**2 / 4.0)
    return float(F[0] / qA)
