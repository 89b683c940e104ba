"""The wall-bounded channel (``flow: channel``): the program built by
``fluca_tpu_torch.models.channel.setup_channel_3d``; the initial fields
drawn from the seed on the device: the laminar profile
u = Re_tau/2 utau (1 - ((y - delta)/delta)^2), times 1 + ``perturb`` n
on the cell velocity u with n white noise, v = w = 0, the face
velocity the laminar profile, p = phalf = 0; and the plain reference's
set-up of the same flow (a frozen copy of ``setup_channel_3d`` without
the solver object)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.bc import BCType, BoundaryCondition, zero_velocity_bc
from benchmark.reference.mesh import CartMesh, stretched_faces


def build_program(cfg: dict, solver, device):
    """The port's NS object for ``cfg`` with the solver config ``solver``;
    returns (ns, None)."""
    from fluca_tpu_torch.models.channel import setup_channel_3d

    ns = setup_channel_3d(N=tuple(cfg["N"]), L=tuple(cfg["L"]), utau=cfg["utau"],
                          Re_tau=cfg["Re_tau"], dt=cfg["dt"], max_steps=10**9,
                          perturb=cfg["perturb"], perturb_mode="noise",
                          stretch_y=cfg.get("stretch_y"), dtype=getattr(torch, cfg["dtype"]),
                          device=device)
    ns.impl.cfg = solver
    return ns, None


def initial_fields(cfg: dict, seed: int, device) -> dict:
    """The state at t = 0 in the configuration's dtype, from ``seed``."""
    N, L = tuple(cfg["N"]), tuple(cfg["L"])
    dtype = getattr(torch, cfg["dtype"])
    delta = L[1] / 2.0
    g = cfg.get("stretch_y")
    ys = np.linspace(0, L[1], N[1] + 1) if g is None else stretched_faces(N[1], delta, float(g))
    cy = 0.5 * (ys[:-1] + ys[1:])
    u_lam = cfg["Re_tau"] / 2.0 * cfg["utau"] * (1.0 - ((cy - delta) / delta) ** 2)
    lam = torch.as_tensor(u_lam, dtype=dtype, device=device)[None, :, None]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn(N, generator=gen, device=device, dtype=dtype)
    u = lam * (1.0 + cfg["perturb"] * noise)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    fshape = [tuple(n + (0 if per else 1) if a == d else n for a, n in enumerate(N))
              for d, per in enumerate((True, False, True))]
    return {"v": (u, zeros(N), zeros(N)),
            "U": (lam.expand(fshape[0]).contiguous(), zeros(fshape[1]), zeros(fshape[2])),
            "p": zeros(N), "phalf": zeros(N)}


def reference_setup(cfg: dict, dtype, device):
    """The plain reference's channel: periodic x and z, no-slip walls in
    y, driven by the mean-pressure-gradient force rho utau^2 / delta.
    Returns (mesh, bcs, rho, mu, body_force)."""
    N, L = tuple(cfg["N"]), tuple(cfg["L"])
    delta, rho, utau = L[1] / 2.0, 1.0, float(cfg["utau"])
    mu = rho * utau * delta / float(cfg["Re_tau"])
    mesh = CartMesh(N=N, periodic=(True, False, True))
    g = cfg.get("stretch_y")
    ys = np.linspace(0, L[1], N[1] + 1) if g is None else stretched_faces(N[1], delta, float(g))
    mesh.set_coordinates(np.linspace(0, L[0], N[0] + 1), ys, np.linspace(0, L[2], N[2] + 1))
    per = BoundaryCondition(BCType.PERIODIC)
    wall = zero_velocity_bc()
    bcs = [per, per, wall, wall, per, per]

    def full(val):
        return torch.full((1, 1, 1), val, dtype=dtype, device=device)

    force = (full(rho * utau**2 / delta), full(0.0), full(0.0))
    return mesh, bcs, rho, mu, (lambda state, t: force)
