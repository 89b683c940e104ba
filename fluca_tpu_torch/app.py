"""Demo application: options-driven lid-driven cavity solver.

Counterpart of fluca_tpu.app (reference fluca/app/main.c): builds
Mesh+NS from the options database, solves, and reports. Run e.g.:

  python -m fluca_tpu_torch.app -device cuda -cart_grid_x 256 \
      -cart_grid_y 256 -ns_max_steps 100 -ns_monitor

``-device`` names the torch device (default ``cuda``; a missing card is
an error, never a silent switch to the CPU). ``-parallel_grid auto |
AxB[xC]`` runs the solver over a device grid whose shards share that
device (``NS.shard``). Restart and output as the reference's main.c:
``-mesh_cart_create_from_file F.cgns``, ``-load_checkpoint DIR``,
``-ns_load_solution_from_file F.cgns`` before the solve;
``-checkpoint DIR`` and ``-ns_view_solution F.cgns`` after it; a
``cgns:F`` solution viewer on the monitors (``-viewer_cgns_batch_size``).
"""

from __future__ import annotations

import sys

import fluca_tpu_torch
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import NS
from fluca_tpu_torch.utils.options import global_options


def build(argv) -> NS:
    """The NS of the options ``argv``, set up: the mesh from the options
    or a CGNS file, walls and a moving lid, rho 400, mu 1, dt 0.002; its
    state restored from a checkpoint or a CGNS solution where the options
    name one (main.c:36-48, 83-88)."""
    fluca_tpu_torch.initialize(argv)
    opts = global_options()

    if opts.has("mesh_cart_create_from_file"):
        from fluca_tpu_torch.io.cgns import mesh_from_cgns

        mesh = mesh_from_cgns(opts.get_str("mesh_cart_create_from_file"))
    else:
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

    if opts.has("load_checkpoint"):
        from fluca_tpu_torch.io.checkpoint import load_checkpoint

        load_checkpoint(opts.get_str("load_checkpoint"), ns)
    # solution restart from CGNS (main.c:84-88): every field, phalf
    # included, and the step and time
    if opts.has("ns_load_solution_from_file"):
        from fluca_tpu_torch.io.cgns import load_solution_cgns

        load_solution_cgns(opts.get_str("ns_load_solution_from_file"), ns)
    return ns


def main(argv=None) -> int:
    ns = build(sys.argv[1:] if argv is None else argv)
    opts = global_options()

    from fluca_tpu_torch.io.viewer import (
        AsciiViewer, create_viewer_from_options,
    )
    from fluca_tpu_torch.ns.monitor import set_monitors_from_options

    viewers = []

    def solution_viewer():
        w = create_viewer_from_options(
            opts, "ns_monitor_solution_viewer", mesh=ns.mesh
        ) or AsciiViewer()
        viewers.append(w)
        return w

    set_monitors_from_options(ns, opts, writer_factory=solution_viewer)

    reason = ns.solve()
    print(f"done: {reason.name} at step {ns.step_index}, t={ns.t:g}")
    # a CGNS viewer writes its time series when closed
    for w in viewers:
        w.close()

    if opts.has("checkpoint"):
        from fluca_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(opts.get_str("checkpoint"), ns)
    if opts.sub("ns_").has("view_solution"):
        from fluca_tpu_torch.io.cgns import CGNSWriter

        with CGNSWriter(opts.sub("ns_").get_str("view_solution"), ns.mesh) as w:
            w.write_solution(ns)

    # -log_view: PETSc-style event summary at exit (nspkg.c:30-34)
    if opts.get_bool("log_view", False):
        from fluca_tpu_torch.utils.profiling import global_log

        print(global_log.view())
    return 0


if __name__ == "__main__":
    sys.exit(main())
