"""Weak scaling of the sharded NS step over growing grids (counterpart of
bench_scaling.py at the repo root): the per-shard problem fixed at
``base`` x ``base`` cells of the Re-100 lid-driven cavity (rho 1, mu 0.01,
dt 0.01, float32, production()), the number of shards grown, steps/s
over ``advance(steps)`` (best of two, after a warm-up) and its efficiency
against one shard.

Two forms:

- one process (``--shards S``, the counterpart of ``--virtual S``): a
  ``DeviceGrid`` of 1, 2, 4, ... S shards on the one device, the grid
  (base * shape) grown with it; one record per count, ``"virtual": true``;

      python -m fluca_tpu_torch.examples.bench_scaling --shards 8 [--base 128]
          [--steps 10] [--device cuda] [--out FILE.json]

- under a launcher, one world size per launch: every rank holds one block
  of a rank-held grid (the ranks factored into a near-square grid) and
  rank 0 prints one record, its steps/s the slowest rank's, its
  efficiency against one process stepping the (base, base) cavity on
  rank 0's device, timed before the ranks step:

      python -m torch.distributed.run --standalone --nproc-per-node 2 \\
          -m fluca_tpu_torch.examples.bench_scaling --backend gloo [--base 128]

The records have the reference's keys (``metric``
``weak_scaling_steps_per_sec``, ``devices``, ``grid``, ``value``,
``efficiency_vs_1dev``, ``platform``, ``virtual``) and the device they ran
on. Ranks that share one card, like the shards of one process, measure
host and transport contention (every edge plane and sum crosses the host
under gloo), not interconnect scaling, as the reference says of its
virtual devices. The script sets no target.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from fluca_tpu_torch.bench import device_info
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import NS, check_device
from fluca_tpu_torch.parallel import distributed
from fluca_tpu_torch.parallel.mesh import _factor, make_device_grid


def cavity(N, device, grid=None) -> NS:
    """The reference harness's cavity on an N[0] x N[1] grid."""
    mesh = CartMesh.create(tuple(N))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    wall = zero_velocity_bc()
    lid = BoundaryCondition(BCType.VELOCITY,
                            velocity=lambda t, xs: (1.0 + 0.0 * xs[0], 0.0 * xs[0]))
    ns = NS(mesh, device=device, rho=1.0, mu=0.01, dt=0.01, max_steps=10**9,
            bcs=[wall, wall, wall, lid], dtype=torch.float32, grid=grid)
    ns.setup()
    ns.impl.cfg = CNLinearConfig.production()
    return ns


def steps_per_s(ns, steps, barrier=None) -> float:
    """Best of two timed ``advance(steps)`` after a step and a warm-up
    advance; ``barrier`` (the ranks') starts every rank's window together."""
    dev = torch.device(ns.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ns.step()
    ns.advance(steps)
    best = float("inf")
    for _ in range(2):
        sync()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        ns.advance(steps)
        sync()
        best = min(best, time.perf_counter() - t0)
    return steps / best


def record(n, N, sps, sps1, device, virtual) -> dict:
    info = device_info(device)
    return {"metric": "weak_scaling_steps_per_sec", "devices": n, "grid": list(N),
            "value": round(sps, 3), "efficiency_vs_1dev": round(sps / sps1, 4),
            "platform": info["platform"], "virtual": virtual, "device": info}


def one_process(base, steps, shards, device) -> list:
    """Records of 1, 2, 4, ... ``shards`` shards on one device."""
    out, n = [], 1
    while n <= shards:
        shape = _factor(n, 2)
        N = (base * shape[0], base * shape[1])
        ns = cavity(N, device)
        ns.shard(make_device_grid(2, devices=[device], shape=shape))
        sps = steps_per_s(ns, steps)
        out.append(record(n, N, sps, out[0]["value"] if out else sps, device, True))
        print(json.dumps(out[-1]), flush=True)
        n *= 2
    return out


def ranks(base, steps):
    """This launch's record on rank 0 (None on the others); every rank of
    the process group must call it."""
    transport = distributed.default_transport()
    device = transport.device
    sps1 = None
    if transport.rank == 0:
        sps1 = steps_per_s(cavity((base, base), device), steps)
    transport.barrier()
    grid = make_device_grid(2)
    N = (base * grid.shape[0], base * grid.shape[1])
    ns = cavity(N, device, grid)
    sps = steps_per_s(ns, steps, transport.barrier)
    slowest = transport.allmax(torch.tensor([1.0 / sps], dtype=torch.float64,
                                            device=device))
    if transport.rank != 0:
        return None
    rec = record(grid.size, N, 1.0 / float(slowest[0]), sps1, device, False)
    rec.update(ranks=grid.size, backend=transport.backend, rank_grid=list(grid.shape))
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=int, default=128, help="cells per shard and axis")
    ap.add_argument("--steps", type=int, default=10, help="steps per timed advance")
    ap.add_argument("--shards", type=int, default=8,
                    help="one process: grow the grid to this many shards")
    ap.add_argument("--backend", choices=("gloo", "nccl"),
                    help="under a launcher: the process group's backend")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=None, help="also write the records to this path")
    args = ap.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        distributed.initialize_distributed(
            backend=args.backend, device=args.device)
        rec = ranks(args.base, args.steps)
        results = [] if rec is None else [rec]
        distributed.finalize_distributed()
    else:
        results = one_process(args.base, args.steps, args.shards, check_device(args.device))
    if args.out and results:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
