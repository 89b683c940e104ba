"""The sphere wake (``flow: sphere``): the program built by
``fluca_tpu_torch.models.sphere.setup_sphere_3d``; the initial fields
drawn from the seed on the device: uniform flow U_in plus white noise of
amplitude ``perturb`` U_in on each cell velocity component, the face
velocities uniform, p = phalf = 0; and the plain reference's set-up of
the same flow (a frozen copy of ``setup_sphere_3d`` without the solver
object)."""

from __future__ import annotations

import torch

from benchmark.reference.bc import BCType, BoundaryCondition
from benchmark.reference.forcing import DirectForcingIBM
from benchmark.reference.markers import sphere_markers
from benchmark.reference.mesh import CartMesh


def build_program(cfg: dict, solver, device):
    """The port's NS object for ``cfg`` with the solver config ``solver``;
    returns (ns, ibm)."""
    from fluca_tpu_torch.models.sphere import setup_sphere_3d

    ns, ibm = setup_sphere_3d(N=tuple(cfg["N"]), domain=tuple(cfg["L"]),
                              center=tuple(cfg["center"]), diameter=cfg["D"], Re=cfg["Re"],
                              U_in=cfg["U_in"], dt=cfg["dt"], max_steps=10**9,
                              kernel=cfg["delta_kernel"], dtype=getattr(torch, cfg["dtype"]),
                              retract=cfg["retract"], device=device)
    ns.impl.cfg = solver
    return ns, ibm


def initial_fields(cfg: dict, seed: int, device) -> dict:
    """The state at t = 0 in the configuration's dtype, from ``seed``."""
    N = tuple(cfg["N"])
    dtype = getattr(torch, cfg["dtype"])
    U_in = float(cfg["U_in"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn((3, *N), generator=gen, device=device, dtype=dtype)
    amp = cfg["perturb"] * U_in
    v = (U_in + amp * noise[0], amp * noise[1], amp * noise[2])
    fshape = [tuple(n + 1 if a == d else n for a, n in enumerate(N)) for d in range(3)]
    return {"v": tuple(x.contiguous() for x in v),
            "U": (torch.full(fshape[0], U_in, dtype=dtype, device=device),
                  torch.zeros(fshape[1], dtype=dtype, device=device),
                  torch.zeros(fshape[2], dtype=dtype, device=device)),
            "p": torch.zeros(N, dtype=dtype, device=device),
            "phalf": torch.zeros(N, dtype=dtype, device=device)}


def reference_setup(cfg: dict, dtype, device):
    """The plain reference's sphere: uniform inflow (-x), pressure outlet
    (+x), symmetry on the lateral planes, a stationary sphere by
    direct-forcing IBM with its markers ``retract`` cell widths inside
    the surface. Returns (mesh, bcs, rho, mu, body_force)."""
    N, L = tuple(cfg["N"]), tuple(cfg["L"])
    U_in, D = float(cfg["U_in"]), float(cfg["D"])
    rho = 1.0
    mu = rho * U_in * D / float(cfg["Re"])
    mesh = CartMesh(N=N, periodic=(False, False, False))
    mesh.set_uniform_coordinates(0.0, L[0], 0.0, L[1], 0.0, L[2])
    inflow = BoundaryCondition(
        BCType.VELOCITY, velocity=lambda t, xs: (U_in + 0.0 * xs[1], 0.0 * xs[1], 0.0 * xs[1]))
    outflow = BoundaryCondition(BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[1])
    sym = BoundaryCondition(BCType.SYMMETRY)
    bcs = [inflow, outflow, sym, sym, sym, sym]
    markers = sphere_markers(mesh, tuple(cfg["center"]), D / 2.0, kernel=cfg["delta_kernel"],
                             dtype=dtype, retract=float(cfg["retract"]), device=device)
    ibm = DirectForcingIBM(markers, float(cfg["dt"]))
    return mesh, bcs, rho, mu, ibm.body_force
