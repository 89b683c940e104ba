"""Channel flows: the 3-D wall-bounded channel driven by a mean
pressure gradient, and the 2-D plane Poiseuille channel with inflow and
outflow (counterpart of fluca_tpu.models.channel).

Analytic 2-D steady state: u(y) = 4 U_max y (H - y) / H^2, v = 0,
p(x) = 8 mu U_max (L - x) / H^2 (zero at the outlet).

Initial conditions are built on the host in float64 numpy, with the
same ``np.random.default_rng(0)`` draws in the same order as the
reference, and then copied to the device (``torch.tensor`` copies, so
no state leaf shares storage with another or with the numpy arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import NS


def poiseuille_exact(mu, U_max, L, H):
    def u(y):
        return 4.0 * U_max * y * (H - y) / H**2

    def p(x):
        return 8.0 * mu * U_max * (L - x) / H**2

    return u, p


def _stretched_faces(n, delta, g):
    """tanh wall clustering in y (standard channel-DNS grid):
    y_j = delta (1 + tanh(g (2j/n - 1)) / tanh(g))."""
    xi = np.linspace(-1.0, 1.0, n + 1)
    if abs(g) < 1e-12:
        return delta * (1.0 + xi)  # g -> 0 limit: uniform spacing
    return delta * (1.0 + np.tanh(g * xi) / np.tanh(g))


def setup_channel_3d(
    N=(64, 32, 32),
    L=(4.0, 2.0, 2.0),
    utau=1.0,
    Re_tau=180.0,
    dt=2e-3,
    max_steps=10,
    perturb=0.1,
    perturb_mode="noise",
    stretch_y=None,
    dtype=None,
    *,
    device,
    **ns_kwargs,
) -> NS:
    """Turbulent channel on ``device`` (BASELINE.json config #5):
    periodic streamwise (x) and spanwise (z), no-slip walls in y, driven
    by the constant mean-pressure-gradient body force
    f_x = rho utau^2 / delta. ``stretch_y`` (g ~ 1.5-2.5) clusters the
    y faces toward the walls; ``perturb_mode`` is "noise" (white noise
    on u) or "rolls" (streamwise rolls, streaks and a little noise).
    ``ns_kwargs`` go to ``NS``; with ``grid=`` a rank-held grid, every
    rank draws the whole initial condition on the host and keeps its
    block of it."""
    delta = L[1] / 2.0
    rho = 1.0
    mu = rho * utau * delta / Re_tau

    mesh = CartMesh.create(N, (True, False, True))
    if stretch_y is None:
        mesh.set_uniform_coordinates(0, L[0], 0, L[1], 0, L[2])
    else:
        mesh.set_coordinates(
            np.linspace(0, L[0], N[0] + 1),
            _stretched_faces(N[1], delta, float(stretch_y)),
            np.linspace(0, L[2], N[2] + 1),
        )

    per = BoundaryCondition(BCType.PERIODIC)
    wall = zero_velocity_bc()
    ns = NS(
        mesh, device=device, rho=rho, mu=mu, dt=dt, max_steps=max_steps,
        dtype=dtype, bcs=[per, per, wall, wall, per, per], **ns_kwargs,
    )
    ns.setup()
    dt_ = ns.impl.dtype
    dev = ns.impl.device

    def full(val):
        # one value broadcast over the cells, so that the force fits any
        # block of them (a rank-held grid)
        return torch.full((1,) * mesh.dim, val, dtype=dt_, device=dev)

    force = (full(rho * utau**2 / delta), full(0.0), full(0.0))
    ns.impl.body_force = lambda state, t: force

    # laminar-profile initial condition + perturbation
    cy = mesh.centers(1)
    u_lam = Re_tau / 2.0 * utau * (1.0 - ((cy - delta) / delta) ** 2)
    rng = np.random.default_rng(0)
    u0 = np.broadcast_to(u_lam[None, :, None], mesh.cell_shape).copy()
    v0 = np.zeros(mesh.cell_shape)
    w0 = np.zeros(mesh.cell_shape)
    if perturb_mode == "noise":
        u0 *= 1.0 + perturb * rng.standard_normal(mesh.cell_shape)
    elif perturb_mode == "rolls":
        # divergence-free streamwise rolls from a vector potential
        # psi = (a/beta) f(y) sin(beta z) xmod(x), low-wavenumber
        # streaks and small noise (as the reference)
        X = mesh.centers(0)[:, None, None]
        Y = cy[None, :, None]
        Z = mesh.centers(2)[None, None, :]
        eta = Y / delta                       # 0..2, walls at 0/2
        f = eta**2 * (2.0 - eta) ** 2         # f, f' vanish at walls
        fp = 2.0 * eta * (2.0 - eta) * (2.0 - 2.0 * eta) / delta
        beta = 2.0 * np.pi * 2.0 / L[2]       # 2 roll pairs across z
        alpha = 2.0 * np.pi / L[0]            # x modulation (3-D)
        s = perturb / 0.2
        a_roll = 2.0 * utau * s
        b_streak = 8.0 * utau * s
        xmod = 1.0 + 0.3 * np.sin(alpha * X)
        v0 += a_roll * f * np.cos(beta * Z) * xmod
        w0 += -(a_roll / beta) * fp * np.sin(beta * Z) * xmod
        u0 += b_streak * f * np.cos(beta * Z + 0.7)
        u0 *= 1.0 + 0.05 * s * rng.standard_normal(mesh.cell_shape)
    else:
        raise ValueError(f"unknown perturb_mode {perturb_mode!r}")

    # the solver's block of each field (the whole grid, or this rank's
    # block of a rank-held grid: ``grid=``)
    blk = ns.impl.ops.block

    def dev_t(a, face=None):
        return torch.tensor(np.ascontiguousarray(blk.cut(a, face)), dtype=dt_, device=dev)

    ns.set_solution(
        v=(dev_t(u0), dev_t(v0), dev_t(w0)),
        U=(
            dev_t(np.broadcast_to(u_lam[None, :, None], mesh.face_shape(0)), 0),
            dev_t(np.zeros(mesh.face_shape(1)), 1),
            dev_t(np.zeros(mesh.face_shape(2)), 2),
        ),
    )
    return ns


def setup_channel_2d(
    N=(64, 32),
    L=2.0,
    H=1.0,
    U_max=1.0,
    mu=0.05,
    dt=0.02,
    max_steps=50,
    exact_init=True,
    dtype=None,
    *,
    device,
) -> NS:
    """Plane Poiseuille channel on ``device``: parabolic VELOCITY
    inflow at x = 0, PRESSURE_OUTLET at x = L, walls in y; started from
    the exact solution unless ``exact_init`` is False."""
    mesh = CartMesh.create(N)
    mesh.set_uniform_coordinates(0.0, L, 0.0, H)
    u_ex, p_ex = poiseuille_exact(mu, U_max, L, H)

    inflow = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: (u_ex(xs[1]) + 0.0 * xs[0], 0.0 * xs[1]),
    )
    outflow = BoundaryCondition(
        BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[1]
    )
    wall = zero_velocity_bc()
    ns = NS(
        mesh, device=device, rho=1.0, mu=mu, dt=dt, max_steps=max_steps,
        dtype=dtype, bcs=[inflow, outflow, wall, wall],
    )
    ns.setup()

    if exact_init:
        dt_, dev = ns.impl.dtype, ns.impl.device

        def dev_t(a):
            return torch.tensor(np.ascontiguousarray(a), dtype=dt_,
                                device=dev)

        Xc, Yc = np.meshgrid(mesh.centers(0), mesh.centers(1), indexing="ij")
        _, Ycf = np.meshgrid(mesh.face_coords(0), mesh.centers(1),
                             indexing="ij")
        p0 = p_ex(Xc)
        ns.set_solution(
            v=(dev_t(u_ex(Yc)), dev_t(np.zeros(mesh.cell_shape))),
            U=(dev_t(u_ex(Ycf)), dev_t(np.zeros(mesh.face_shape(1)))),
            p=dev_t(p0),
            phalf=dev_t(p0),
        )
    return ns
