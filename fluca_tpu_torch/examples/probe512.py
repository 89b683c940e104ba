"""The card's copy rate over field shapes and rows per block, and the 3-D
momentum kernel at the BASELINE #5 shape (counterpart of the repo's
``examples/probe512.py``).

1. The copy (``ops/probes.py`` ``copy_scale``) over the shapes and tile
   heights of ``examples/probe512.py:67-75``: 134 MB in three shapes
   (512x256x256 at 8 and 16 rows per block, 8192x4096), a 67 MB 3-D and
   a 67 MB 2-D control, and 268 MB in 2-D. On the TPU this sweep found a
   rate cliff for fields of 134 MB and more (``PROBE512.json``).
2. The momentum 3-D kernel (``ops/cuda_stencil.py`` ``momentum3d``) on
   random factors of the wall-clustered channel at (512, 128, 256) and
   (512, 256, 256), with the rate of the reference's 30-stream byte
   model (30 f32 fields read or written per cell). The reference's split-
   against-full comparison (``examples/probe512.py:77-128``) has no
   counterpart: the port's momentum kernel has one form, and the TPU's
   split mode is a VMEM layout rule of the Pallas kernel.

    python -m fluca_tpu_torch.examples.probe512 [--device cuda] [--out PATH]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fluca_tpu_torch.bench import slope_time_per_iter
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.ops.probes import copy_scale

F32 = torch.float32
# (shape, rows per block, label): examples/probe512.py:67-75
COPY_CASES = (
    ((512, 256, 256), 8, "copy512_tm8"),
    ((512, 256, 256), 16, "copy512_tm16"),
    ((256, 256, 256), 8, "copy256cube_tm8"),
    ((8192, 4096), 256, "copy134MB_2d"),
    ((16384, 4096), 256, "copy268MB_2d"),
    ((4096, 4096), 128, "copy67MB_2d"),
)
MOMENTUM_SHAPES = ((512, 128, 256), (512, 256, 256))
# the reference's channel: rho 1, mu 1/180, dt 1e-3 (probe512.py:84)
RHO, MU, DT = 1.0, 1.0 / 180.0, 1e-3


def copy_gbps(shape, rows, device) -> float:
    """The copy's rate in GB/s (one read and one write of the field)."""
    x = torch.ones(shape, dtype=F32, device=device)
    t = slope_time_per_iter(lambda a: copy_scale(a, rows=rows), x, 20, 120)
    return 2 * x.numel() * 4 / t / 1e9


def channel_momentum(N, device, gen):
    """The momentum kernel's bands for the tanh-clustered channel of
    ``N`` cells, random factors and a random v from ``gen``
    (probe512.py:84-104)."""
    mesh = CartMesh.create(N, (True, False, True))
    xi = np.linspace(-1.0, 1.0, N[1] + 1)
    mesh.set_coordinates(np.linspace(0, 4, N[0] + 1), 1.0 + np.tanh(2.0 * xi) / np.tanh(2.0),
                         np.linspace(0, 2, N[2] + 1))
    per = BoundaryCondition(BCType.PERIODIC)
    wall = zero_velocity_bc()
    axbcs = T_.axis_bcs(mesh, [per, per, wall, wall, per, per])
    bands = cuda_stencil.Momentum3DBands.from_host(
        cuda_stencil.build_momentum_bands_3d(mesh, axbcs, RHO, MU, DT), mesh.periodic, F32,
        device)

    def rand(shape):
        return torch.randn(shape, generator=gen, dtype=F32, device=device)

    v = tuple(rand(mesh.cell_shape) for _ in range(3))
    U0 = tuple(rand(mesh.face_shape(d)) for d in range(3))
    v0f = tuple(tuple(rand(mesh.face_shape(d)) for _ in range(3)) for d in range(3))
    return bands, cuda_stencil.Momentum3DFactors.from_faces(U0, v0f, bands), v


def momentum_ms(N, device) -> float:
    """The momentum 3-D kernel's ms per apply at ``N``."""
    gen = torch.Generator(device=device).manual_seed(3)
    bands, f, v = channel_momentum(N, device, gen)
    t = slope_time_per_iter(lambda x: cuda_stencil.momentum3d(bands, f, x), v, 5, 30)
    return t * 1e3


def run(device="cuda", copy_cases=COPY_CASES, momentum_shapes=MOMENTUM_SHAPES) -> dict:
    device = check_device(device)
    out = {}
    for shape, rows, label in copy_cases:
        out[label] = copy_gbps(shape, rows, device)
        print(f"{label}: {out[label]:.1f} GB/s", flush=True)
    for N in momentum_shapes:
        tag = "x".join(map(str, N))
        ms = momentum_ms(N, device)
        out[f"mom3d_{tag}_ms"] = ms
        out[f"mom3d_{tag}_gbps_30stream"] = 30 * math.prod(N) * 4 / (ms / 1e3) / 1e9
        print(f"momentum3d {N}: {ms:.3f} ms", flush=True)
    return out


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(run(device=args.device), args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
