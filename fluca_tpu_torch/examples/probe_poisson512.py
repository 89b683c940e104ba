"""Where does the 3-D Poisson apply lose its time at the BASELINE #5
shape? (counterpart of the repo's ``examples/probe_poisson512.py``)

Level 0 of the 512x256x256 channel's multigrid (x and z periodic, y
walls), f32, each timed by its slope and reported as ms and as an
effective rate (one read and one write of the field):

  copy_tm8        ``copy_scale``, 8 rows per block: the card's copy;
  stencil_full    the port's ``poisson3d`` apply, the kernel itself;
  stencil_rebuilt ``poisson3d_variant`` "rebuilt": the same arithmetic,
                  in-plane edges from zero edge inputs (as the reference
                  passes them), axis-0 neighbours read in place;
  stencil_noroll  "noroll": in-plane neighbours read as the centre value;
  stencil_nocomp  "nocomp": the copy through the stencil's launch
                  geometry.

    python -m fluca_tpu_torch.examples.probe_poisson512 [--device cuda] [--out PATH]
"""

from __future__ import annotations

import math

import torch

from fluca_tpu_torch.bench import slope_time_per_iter
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops.probes import copy_scale, poisson3d_variant, variant_edge_shapes
from fluca_tpu_torch.solvers.mg import PoissonMG

F32 = torch.float32


def channel_level0(N, device):
    """Level 0 of the multigrid of the uniform channel of ``N`` cells
    on [0, 4] x [0, 2] x [0, 2] (probe_poisson512.py:113-121)."""
    mesh = CartMesh.create(N, (True, False, True))
    mesh.set_uniform_coordinates(0, 4, 0, 2, 0, 2)
    per = BoundaryCondition(BCType.PERIODIC)
    wall = zero_velocity_bc()
    return PoissonMG(mesh, [per, per, wall, wall, per, per], scale=1.0, dtype=F32,
                     device=device)


def run(device="cuda", N=(512, 256, 256)) -> dict:
    device = check_device(device)
    mg = channel_level0(N, device)
    coeffs = mg.levels[0].coeffs
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(N, generator=gen, dtype=F32, device=device) * 1e-3
    edges = tuple(torch.zeros(s, dtype=F32, device=device) for s in variant_edge_shapes(N))
    gb = 2 * math.prod(N) * 4 / 1e9
    out = {}

    def rec(name, fn):
        t = slope_time_per_iter(fn, x, 20, 80)
        out[name] = {"ms": t * 1e3, "eff_gbps": gb / t}
        print(f"  {name:18s}: {t * 1e3:8.4f} ms  {gb / t:7.1f} GB/s-effective", flush=True)

    rec("copy_tm8", lambda p: copy_scale(p, rows=8))
    rec("stencil_full", mg.apply_op)
    for mode in ("rebuilt", "noroll", "nocomp"):
        rec(f"stencil_{mode}", lambda p, mode=mode: poisson3d_variant(mode, p, coeffs, edges))
    return out


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(run(device=args.device), args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
