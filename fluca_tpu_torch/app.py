"""Demo application: options-driven lid-driven cavity solver.

Counterpart of fluca_tpu.app (reference fluca/app/main.c): builds
Mesh+NS from the options database, solves, and reports. Run e.g.:

  python -m fluca_tpu_torch.app -device cuda -cart_grid_x 256 \
      -cart_grid_y 256 -ns_max_steps 100 -ns_monitor

``-device`` names the torch device (default ``cuda``; a missing card is
an error, never a silent switch to the CPU). ``-parallel_grid auto |
AxB[xC]`` runs the solver over a device grid whose shards share that
device (``NS.shard``). Options whose subsystems are not ported yet raise
NotImplementedError.
"""

from __future__ import annotations

import sys

import fluca_tpu_torch
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import NS
from fluca_tpu_torch.utils.options import global_options

# options of subsystems still to be ported -> the ROADMAP item that
# brings them
_NOT_PORTED = {
    "checkpoint": "checkpoint I/O (ROADMAP queue 1, item 2)",
    "load_checkpoint": "checkpoint I/O (ROADMAP queue 1, item 2)",
    "mesh_cart_create_from_file": "CGNS I/O (ROADMAP queue 1, item 2)",
    "ns_load_solution_from_file": "CGNS I/O (ROADMAP queue 1, item 2)",
    "ns_view_solution": "CGNS I/O (ROADMAP queue 1, item 2)",
}


def build(argv) -> NS:
    """The NS of the options ``argv``, set up: the mesh from the
    options, walls and a moving lid, rho 400, mu 1, dt 0.002."""
    fluca_tpu_torch.initialize(argv)
    opts = global_options()
    for name, what in _NOT_PORTED.items():
        if opts.has(name):
            raise NotImplementedError(f"-{name} needs {what}")

    mesh = CartMesh.from_options(opts)
    wall = zero_velocity_bc()
    lid = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: tuple(
            (1.0 + 0.0 * xs[0]) if c == 0 else 0.0 * xs[0]
            for c in range(mesh.dim)
        ),
    )
    bcs = [wall] * (2 * mesh.dim)
    bcs[3] = lid  # moving top lid (main.c:52-66)

    ns = NS(
        mesh,
        device=opts.get_str("device", "cuda"),
        rho=400.0,
        mu=1.0,
        dt=0.002,
        max_steps=1000,
        bcs=bcs,
        options=opts,
    )
    ns.set_from_options()
    ns.setup()

    # domain decomposition (the reference's mpiexec -n N x
    # -cart_ranks_* path): -parallel_grid auto | AxB[xC]. The shards share
    # the solver's one device; "auto" factors the devices given, one.
    if opts.has("parallel_grid"):
        spec = opts.get_str("parallel_grid")
        shape = (None if spec in ("", "auto", "true")
                 else tuple(int(x) for x in spec.split("x")))
        ns.shard(shape=shape)
        grid = ns.device_grid
        print(f"parallel: {len(set(grid.devices))} devices, grid "
              f"{dict(zip(grid.axis_names, grid.shape))}")
    return ns


def main(argv=None) -> int:
    ns = build(sys.argv[1:] if argv is None else argv)
    opts = global_options()

    from fluca_tpu_torch.io.viewer import (
        AsciiViewer, create_viewer_from_options,
    )
    from fluca_tpu_torch.ns.monitor import set_monitors_from_options

    set_monitors_from_options(
        ns, opts,
        writer_factory=lambda: create_viewer_from_options(
            opts, "ns_monitor_solution_viewer"
        ) or AsciiViewer(),
    )

    reason = ns.solve()
    print(f"done: {reason.name} at step {ns.step_index}, t={ns.t:g}")

    # -log_view: PETSc-style event summary at exit (nspkg.c:30-34)
    if opts.get_bool("log_view", False):
        from fluca_tpu_torch.utils.profiling import global_log

        print(global_log.view())
    return 0


if __name__ == "__main__":
    sys.exit(main())
