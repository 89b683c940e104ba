"""Bytes each rank sends per production step of the rank-held cavity
(counterpart of examples/ici_bytes.py), read from the transport's
counters (``parallel/distributed.py`` ``TransportStats``).

The 256^2 Re-100 cavity, float32, production() (o3/m8/s6), one block per
rank of a ``--grid`` rank grid: the first step, then the counters reset,
then one more step, whose counters every rank reports: the exchanges
(batches of edge planes, and the bytes this rank sends in them), the sums
(dots, norms, means, each rank's part once) and the gathers (the multigrid
level the grid stops splitting, gathered to every rank), with their
counts. Rank 0 prints one JSON object with every rank's figures, the
largest per kind, the halo-surface model of SCALING.md (150 applies per
step x 8 lines x the local edge x 4 bytes), and the reference's record of
the same grid where it has one.

The reference reads its bytes out of the compiled HLO over virtual
devices (ICI_BYTES_2dev.json: 4,018,652 bytes per device per step on
(2, 1), 3,723,264 of them all-gathers). The two transports differ on
purpose: the port's faces are owned lo + hilast, so no face array is ever
all-gathered, and its edge planes go rank to rank only where a stencil
reads past a block; the reference's GSPMD placement keeps face arrays
replicated along their axis and all-gathers them. The reference's numbers
are its own (its TPU program), not the port's.

Run under a launcher, one grid per launch (ranks that share one card take
gloo):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m fluca_tpu_torch.examples.ici_bytes --backend gloo --grid 2x1 \\
        [--N 256] [--device cuda] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from fluca_tpu_torch.bench import device_info
from fluca_tpu_torch.models.cavity import setup_cavity_2d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.parallel import distributed
from fluca_tpu_torch.parallel.mesh import make_device_grid

# the reference's records of the same cell (fluca_tpu's HLO over virtual
# devices, examples/ici_bytes.py): bytes per device per step, all of them
# and those of its all-gathers
REFERENCE = {
    (2, 1): {"file": "ICI_BYTES_2dev.json", "per_device_bytes_per_step": 4018652,
             "all_gather_bytes": 3723264, "collective_count_per_step": 425},
    (4, 2): {"file": "ICI_BYTES_8dev.json", "per_device_bytes_per_step": 12303400,
             "all_gather_bytes": 12034048, "collective_count_per_step": 903},
}
KINDS = ("exchange", "sum", "gather")


def measure(shape, N=256):
    """The step's traffic of this rank grid ``shape``; every rank of the
    process group must call it. Returns the record on rank 0, else None."""
    transport = distributed.default_transport()
    shape = tuple(int(s) for s in shape)
    ns = setup_cavity_2d(N=N, Re=100.0, dt=0.01, max_steps=10**9, dtype=torch.float32,
                         device=transport.device, grid=make_device_grid(2, shape=shape))
    ns.impl.cfg = CNLinearConfig.production()
    ns.step()
    st = transport.stats
    st.reset()
    ns.step()
    mine = torch.tensor([st.exchanges, st.exchange_bytes, st.sums, st.sum_bytes,
                         st.gathers, st.gather_bytes], dtype=torch.float64)
    ranks = [[int(x) for x in t.tolist()] for t in transport.all_gather(mine.to(transport.device))]
    if transport.rank != 0:
        return None
    by_rank = [{k: {"count": r[2 * i], "bytes": r[2 * i + 1]} for i, k in enumerate(KINDS)}
               for r in ranks]
    total = [sum(r[1::2]) for r in ranks]
    edge = max(N // shape[0], N // shape[1])
    out = {
        "ranks": len(ranks), "grid_shape": list(shape), "N": [N, N],
        "config": "production o3/m8/s6 f32 cavity step",
        "backend": transport.backend,
        "per_rank_bytes_per_step": max(total),
        "per_rank_mb_per_step": round(max(total) / 1e6, 3),
        "count_per_step": max(sum(r[0::2]) for r in ranks),
        "by_kind": {k: {"count": max(b[k]["count"] for b in by_rank),
                        "bytes": max(b[k]["bytes"] for b in by_rank)} for k in KINDS},
        "by_rank": by_rank,
        "scaling_md_halo_model_bytes": 150 * 8 * edge * 4,
        "reference": REFERENCE.get(shape),
        "device": device_info(transport.device),
        "note": ("bytes this rank sends per production step: its edge planes, and its "
                 "own part (once) of every sum and gather; the most over the ranks per "
                 "kind. Faces are owned lo + hilast, so no face array is all-gathered; "
                 "the reference's figures are its HLO's over virtual devices."),
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default="2x1", help="rank grid, e.g. 2x1 or 4x2")
    ap.add_argument("--N", type=int, default=256, help="cells per axis")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True,
                    help="the process group's backend")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=None, help="also write the record to this path")
    args = ap.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        raise SystemExit("ici_bytes runs under a launcher, one rank per block of --grid")
    distributed.initialize_distributed(
        backend=args.backend, device=args.device)
    rec = measure([int(s) for s in args.grid.split("x")], args.N)
    if rec is not None:
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=1)
    distributed.finalize_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
