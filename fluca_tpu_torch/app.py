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

Under a launcher (``WORLD_SIZE`` > 1, or a process group already joined)
the app runs one block of the grid per rank:

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m fluca_tpu_torch.app -cart_grid_x 64 -cart_grid_y 64 \
      -parallel_grid 2x1 -parallel_backend gloo -ns_max_steps 3 -checkpoint DIR

``-parallel_backend gloo|nccl`` names the backend (never inferred) and
``-parallel_grid`` the rank grid (``auto`` factors the ranks), which the
solver takes before it is built (``NS(grid=)``). A bare ``-device cuda``
is the current card under gloo (ranks that share it) and
``cuda:<LOCAL_RANK>`` under nccl. The checkpoint and CGNS options then
write and read per-rank files (the "sharded" format, the hyperslab CGNS
writer); the monitor, the ASCII viewer and the ``parallel:`` and
``done:`` lines print on rank 0 only, the viewer's maxima taken over the
ranks.
"""

from __future__ import annotations

import sys

import fluca_tpu_torch
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import NS
from fluca_tpu_torch.utils import profiling
from fluca_tpu_torch.utils.options import Options, global_options


def _print_rank0(text: str) -> None:
    """Print on rank 0 of the process group (every process where none was
    joined), as PetscPrintf prints on the world communicator."""
    from fluca_tpu_torch.parallel import distributed

    if distributed.rank() == 0:
        print(text)


def _join_ranks(opts):
    """Join the launcher's process group where one is asked for (a
    ``WORLD_SIZE`` above 1) or already joined, with the backend that
    ``-parallel_backend`` names; this rank's device where the run is over
    more than one rank, else None."""
    import os

    import torch.distributed as dist

    from fluca_tpu_torch.parallel import distributed

    joined = dist.is_available() and dist.is_initialized()
    if not joined and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    backend = opts.get_str("parallel_backend", None)
    distributed.check_backend(backend)
    if joined and dist.get_backend() != backend:
        raise ValueError(f"-parallel_backend {backend}, but the process group this "
                         f"process joined runs {dist.get_backend()}")
    device = distributed.initialize_distributed(
        backend=backend, device=opts.get_str("device", "cuda"))
    return device if distributed.world_size() > 1 else None


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

    spec = opts.get_str("parallel_grid") if opts.has("parallel_grid") else None
    shape = (None if spec in (None, "", "auto", "true")
             else tuple(int(x) for x in spec.split("x")))
    device, grid = _join_ranks(opts), None
    if device is not None:
        if spec is None:
            raise ValueError("a launch over ranks needs -parallel_grid auto | AxB[xC]: "
                             "the grid of one block per rank")
        from fluca_tpu_torch.parallel.mesh import make_device_grid

        grid = make_device_grid(mesh.dim, shape=shape)
    else:
        device = opts.get_str("device", "cuda")

    ns = NS(
        mesh,
        device=device,
        rho=400.0,
        mu=1.0,
        dt=0.002,
        max_steps=1000,
        bcs=bcs,
        options=opts,
        grid=grid,
    )
    ns.set_from_options()
    ns.setup()

    # domain decomposition (the reference's mpiexec -n N x
    # -cart_ranks_* path): -parallel_grid auto | AxB[xC]. On one process
    # the shards share the solver's one device; "auto" factors the devices
    # given, one.
    if grid is not None:
        _print_rank0(f"parallel: {grid.size} ranks ({grid.transport.backend}), grid "
                     f"{dict(zip(grid.axis_names, grid.shape))}")
    elif spec is not None:
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
    argv = sys.argv[1:] if argv is None else argv
    # -log_view: the spans and counters of the run, from start-up on
    if not Options.from_argv(argv).get_bool("log_view", False):
        return _main(argv)
    with profiling.tracing() as log:
        return _main(argv, log)


def _main(argv, log=None) -> int:
    import torch.distributed as dist

    from fluca_tpu_torch.parallel import distributed

    joined = dist.is_available() and dist.is_initialized()
    ns = build(argv)
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
    _print_rank0(f"done: {reason.name} at step {ns.step_index}, t={ns.t:g}")
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

    # -log_view: the table of the spans and counters at exit
    # (nspkg.c:30-34)
    if log is not None:
        _print_rank0(log.view())
    # leave a process group that this run joined (not one its caller did)
    if not joined and dist.is_available() and dist.is_initialized():
        distributed.finalize_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
