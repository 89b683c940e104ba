"""Lid-driven cavity flow (reference:
fluca/tests/cavity_flow/cavity_flow_2d.c, cavity_flow_3d.c and
fluca/app/main.c)."""

from __future__ import annotations

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import NS


def setup_cavity_2d(
    N=256,
    Re=100.0,
    dt=1e-2,
    max_steps=100,
    lid_speed=1.0,
    dtype=None,
    *,
    device,
    **ns_kwargs,
) -> NS:
    """Re=100, unit square, moving top lid (cavity_flow_2d.c:28-37),
    on ``device``. ``ns_kwargs`` go to ``NS`` (``grid=``: a device grid,
    or a rank-held one that builds the solver on this rank's block)."""
    mesh = CartMesh.create((N, N))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)

    wall = zero_velocity_bc()
    lid = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: (lid_speed + 0.0 * xs[0], 0.0 * xs[0]),
    )
    ns = NS(
        mesh, device=device, rho=1.0, mu=1.0 / Re, dt=dt,
        max_steps=max_steps, dtype=dtype, bcs=[wall, wall, wall, lid],
        **ns_kwargs,
    )
    ns.setup()
    return ns


def setup_cavity_3d(
    N=(64, 64, 32),
    Re=100.0,
    dt=1e-2,
    max_steps=100,
    lid_speed=1.0,
    symmetry_back=True,
    dtype=None,
    *,
    device,
    **ns_kwargs,
) -> NS:
    """3-D lid-driven cavity on ``device``: moving +y lid, walls
    elsewhere, with an optional SYMMETRY plane at the low-z (BACK)
    boundary, the reference's half-depth configuration: z in [0, 0.5],
    symmetry on BACK (-z), wall on FRONT (+z) (cavity_flow_3d.c:39-42,
    61-76)."""
    if isinstance(N, int):
        N = (N, N, N)
    mesh = CartMesh.create(tuple(N))
    zmax = 0.5 if symmetry_back else 1.0
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0, 0.0, zmax)

    wall = zero_velocity_bc()
    lid = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: (
            lid_speed + 0.0 * xs[0], 0.0 * xs[0], 0.0 * xs[0],
        ),
    )
    # boundary order: left, right, down, up, back, front = 0..5
    # (MeshCartGetBoundaryIndex, cart.c:564-591); BACK is -z
    back = BoundaryCondition(BCType.SYMMETRY) if symmetry_back else wall
    ns = NS(
        mesh, device=device, rho=1.0, mu=1.0 / Re, dt=dt,
        max_steps=max_steps, dtype=dtype,
        bcs=[wall, wall, wall, lid, back, wall], **ns_kwargs,
    )
    ns.setup()
    return ns
