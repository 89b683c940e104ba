"""Is the card's copy rate a property of each buffer or of the whole
working set? (counterpart of the repo's ``examples/probe512split.py``,
its five measurements, ``:64-131``)

1. one 134 MB buffer (512x256x256 f32), 8 rows per block;
2. two 67 MB buffers (256x256x256), one launch each;
3. the same two buffers, both pairs in one launch (``copy_scale(a, b)``);
4. one 67 MB buffer;
5. the library row: ``torch.mul(a, 1.0000001)`` on 134 MB and on 67 MB,
   the PyTorch call that computes the copy's function (the reference's
   "XLA" rows).

Rates count one read and one write of every buffer.

    python -m fluca_tpu_torch.examples.probe512split [--device cuda] [--out PATH]
"""

from __future__ import annotations

import math

import torch

from fluca_tpu_torch.bench import slope_time_per_iter
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops.probes import SCALE, copy_scale

F32 = torch.float32
ROWS = 8


def run(device="cuda", shape=(512, 256, 256), half=(256, 256, 256)) -> dict:
    device = check_device(device)
    def gbps(n_cells, t):
        return 2 * n_cells * 4 / t / 1e9

    def slope(fn, x):
        return slope_time_per_iter(fn, x, 20, 80)

    out = {}
    x = torch.ones(shape, dtype=F32, device=device)
    xa = torch.ones(half, dtype=F32, device=device)
    xb = torch.full(half, 2.0, dtype=F32, device=device)
    n, n_half = math.prod(shape), math.prod(half)
    out["copy_134MB_single"] = gbps(n, slope(lambda a: copy_scale(a, rows=ROWS), x))
    out["copy_2x67MB_two_kernels"] = gbps(2 * n_half, slope(
        lambda ab: (copy_scale(ab[0], rows=ROWS), copy_scale(ab[1], rows=ROWS)), (xa, xb)))
    out["copy_2x67MB_one_kernel"] = gbps(2 * n_half, slope(
        lambda ab: copy_scale(*ab, rows=ROWS), (xa, xb)))
    out["copy_67MB_single"] = gbps(n_half, slope(lambda a: copy_scale(a, rows=ROWS), xa))
    out["torch_mul_134MB"] = gbps(n, slope(lambda a: torch.mul(a, SCALE), x))
    out["torch_mul_67MB"] = gbps(n_half, slope(lambda a: torch.mul(a, SCALE), xa))
    for k, v in out.items():
        print(f"{k}: {v:.1f} GB/s", flush=True)
    return out


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(run(device=args.device), args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
