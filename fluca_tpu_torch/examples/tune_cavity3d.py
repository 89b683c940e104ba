"""The outer/inner form split on the 64x64x32 cavity (Re 100, dt 0.01,
float32; counterpart of examples/tune_cavity3d.py): steps/s of the
production preset (GCR outer, fixed-budget inner solves), with an FGMRES
outer, with the inner solves in their tolerance-checked loop form (rtol
1e-19, which never converges early), and with both (the reference's r3
form), to tell which change moves the step's time.

    python -m fluca_tpu_torch.examples.tune_cavity3d [--N 64x64x32] [--steps 30]
        [--device cuda] [--out PATH]

Prints one JSON line: steps/s by label.
"""

from __future__ import annotations

import torch

from fluca_tpu_torch.bench import _advance_throughput
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.cavity import setup_cavity_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device


def _fgmres(c):
    c.outer_type = "fgmres"


def _loops(c):
    c.mom_rtol = 1e-19
    c.schur_rtol = 1e-19


def _r3form(c):
    _fgmres(c)
    _loops(c)


# label, change to the production preset (examples/tune_cavity3d.py:37-52)
FORMS = [
    ("gcr+fixed (r4 production)", lambda c: None),
    ("fgmres+fixed", _fgmres),
    ("gcr+while_loops", _loops),
    ("fgmres+while_loops (r3 form)", _r3form),
]


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--N", default="64x64x32")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    N = tuple(int(n) for n in args.N.split("x"))
    out = {}
    for label, mutate in FORMS:
        cfg = CNLinearConfig.production()
        mutate(cfg)
        ns = setup_cavity_3d(N=N, Re=100.0, dt=0.01, max_steps=10**9, dtype=torch.float32,
                             device=device)
        ns.impl.cfg = cfg
        out[label] = round(_advance_throughput(ns, args.steps), 3)
        del ns
    emit({"grid": list(N), "steps": args.steps, "steps_per_sec": out}, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
