"""The 2-D cylinder wake (``flow: cylinder``): the program built by
``fluca_tpu_torch.models.cylinder.setup_cylinder_2d``; the initial fields
drawn from the seed on the device: uniform flow U_in plus white noise of
amplitude ``perturb`` U_in on each cell velocity component, the face
velocities uniform, p = phalf = 0; and the plain reference's set-up of
the same flow (a frozen copy of ``setup_cylinder_2d`` without the solver
object, with the circle's markers built here: the reference has the
sphere's only)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.bc import BCType, BoundaryCondition
from benchmark.reference.forcing import DirectForcingIBM
from benchmark.reference.markers import MarkerSet
from benchmark.reference.mesh import CartMesh


def build_program(cfg: dict, solver, device):
    """The port's NS object for ``cfg`` with the solver config ``solver``;
    returns (ns, ibm)."""
    from fluca_tpu_torch.models.cylinder import setup_cylinder_2d

    ns, ibm = setup_cylinder_2d(N=tuple(cfg["N"]), domain=tuple(cfg["L"]),
                                center=tuple(cfg["center"]), diameter=cfg["D"], Re=cfg["Re"],
                                U_in=cfg["U_in"], dt=cfg["dt"], max_steps=10**9,
                                kernel=cfg["delta_kernel"], dtype=getattr(torch, cfg["dtype"]),
                                device=device)
    ns.impl.cfg = solver
    return ns, ibm


def initial_fields(cfg: dict, seed: int, device) -> dict:
    """The state at t = 0 in the configuration's dtype, from ``seed``."""
    N = tuple(cfg["N"])
    dtype = getattr(torch, cfg["dtype"])
    U_in = float(cfg["U_in"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn((2, *N), generator=gen, device=device, dtype=dtype)
    amp = cfg["perturb"] * U_in
    v = (U_in + amp * noise[0], amp * noise[1])
    fshape = [tuple(n + 1 if a == d else n for a, n in enumerate(N)) for d in range(2)]
    return {"v": tuple(x.contiguous() for x in v),
            "U": (torch.full(fshape[0], U_in, dtype=dtype, device=device),
                  torch.zeros(fshape[1], dtype=dtype, device=device)),
            "p": torch.zeros(N, dtype=dtype, device=device),
            "phalf": torch.zeros(N, dtype=dtype, device=device)}


def circle_markers(mesh: CartMesh, center, radius, kernel, dtype, device) -> MarkerSet:
    """Markers on the circle spaced about h, each owning arc length times
    h (a frozen copy of the port's ``circle_markers`` at its defaults:
    ceil(2 pi r / h) markers, at least 8, on the radius itself)."""
    h = float(mesh.widths(0)[0])
    n = max(int(np.ceil(2 * np.pi * radius / h)), 8)
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    X = np.stack([center[0] + radius * np.cos(th), center[1] + radius * np.sin(th)], axis=1)
    ds = np.full(n, 2 * np.pi * radius / n * h)
    return MarkerSet(mesh, torch.tensor(X, dtype=dtype, device=device),
                     torch.tensor(ds, dtype=dtype, device=device), kernel)


def reference_setup(cfg: dict, dtype, device):
    """The plain reference's cylinder: uniform inflow (-x), pressure
    outlet (+x), symmetry on the lateral lines, a stationary cylinder by
    direct-forcing IBM with its markers on the surface. Returns (mesh,
    bcs, rho, mu, body_force)."""
    N, L = tuple(cfg["N"]), tuple(cfg["L"])
    U_in, D = float(cfg["U_in"]), float(cfg["D"])
    rho = 1.0
    mu = rho * U_in * D / float(cfg["Re"])
    mesh = CartMesh(N=N, periodic=(False, False))
    mesh.set_uniform_coordinates(0.0, L[0], 0.0, L[1])
    inflow = BoundaryCondition(
        BCType.VELOCITY, velocity=lambda t, xs: (U_in + 0.0 * xs[1], 0.0 * xs[1]))
    outflow = BoundaryCondition(BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[1])
    sym = BoundaryCondition(BCType.SYMMETRY)
    bcs = [inflow, outflow, sym, sym]
    markers = circle_markers(mesh, tuple(cfg["center"]), D / 2.0, cfg["delta_kernel"], dtype,
                             device)
    ibm = DirectForcingIBM(markers, float(cfg["dt"]))
    return mesh, bcs, rho, mu, ibm.body_force
