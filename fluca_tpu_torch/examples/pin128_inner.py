"""The bf16 pin's first step (pin128.py: the 128^2 Re-100 cavity, dt 0.005,
float32 production(3, 8, 6), the bf16 preconditioner on both inner solves)
taken apart call by call, to find where a card's run and a CPU's part.

    python -m fluca_tpu_torch.examples.pin128_inner --save PATH [--poisson-calls NPZ]
    python -m fluca_tpu_torch.examples.pin128_inner --compare PATH --device cpu

``--save`` runs the step on ``--device`` (default cuda) and writes every
call of the bf16 momentum and Schur solves (its inputs and result) and of
the bf16 Poisson and momentum kernels (the same) to PATH. ``--compare``
runs the same step on ``--device``, records its own calls, and reports for
each solve call: how far this run's inputs and result lie from the saved
ones, and how far this device's solve, given the saved call's own inputs,
lies from the saved result; and for the kernel calls, the plain version on
each saved call's inputs against the saved output, in bf16 units in the
last place. A kernel that rounds once as its plain version does parts from
it by at most one unit, at a few cells; a solve that is the same function
gives, from the same inputs, the same result up to such roundings.
``--poisson-calls`` also writes the bf16 Poisson calls POISSON_EXPORT of
the first Schur solve (one of each mode at 128^2, where the cells' terms
cancel) to a small npz: bf16 fields as their 16 bits, the level's float32
coefficients; tests/test_torch_bf16_witness.py holds the plain version
against such a card's record bit for bit. Prints one JSON line.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.examples.pin128 import bf16_both
from fluca_tpu_torch.models.cavity import setup_cavity_2d
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil

BF16 = torch.bfloat16
KERNEL_CALLS = 120  # bf16 kernel calls kept, per kernel
# the first Schur solve's bf16 Poisson calls written by --poisson-calls: a
# smooth, the first apply, a smooth and a residual at 128^2
POISSON_EXPORT = (8, 10, 12, 13)


def to(x, device, memo=None):
    """``x`` (a tensor, a tuple of them, Poisson coefficients or a plain
    value) detached onto ``device``. With ``memo``, a tensor met before
    maps to the same copy (held there with its original), so that a
    coefficient array passed to many calls is saved once."""
    if isinstance(x, torch.Tensor):
        if memo is None:
            return x.detach().to(device).clone()
        if id(x) not in memo:
            memo[id(x)] = (x, x.detach().to(device).clone())
        return memo[id(x)][1]
    if isinstance(x, tuple):
        return tuple(to(y, device, memo) for y in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to(getattr(x, f.name), device, memo)
                                         for f in dataclasses.fields(x)
                                         if isinstance(getattr(x, f.name), torch.Tensor)})
    return x


def solver(device):
    ns = setup_cavity_2d(N=128, Re=100.0, dt=0.005, max_steps=10**9, dtype=torch.float32,
                         device=device)
    ns.impl.cfg = bf16_both()
    return ns


def record_step(ns):
    """The first step of ``ns``, with its bf16 solve and kernel calls on the
    CPU: {"momentum": [(rhs, Acoeffs, diagA, out)], "schur": [(rhs, out)],
    "poisson2d": [(mode, p, c, b, w, omega, out)], "momentum2d": [(W, u, v,
    periodic, out)]} and the fields after the step."""
    impl = ns.impl
    rec = {"momentum": [], "schur": [], "poisson2d": [], "momentum2d": []}
    memo = {}
    solve_m, solve_s = impl._solve_momentum, impl._solve_schur

    def momentum(rhs_v, Acoeffs, diagA):
        out = solve_m(rhs_v, Acoeffs, diagA)
        if rhs_v[0].dtype == BF16:
            rec["momentum"].append(to((rhs_v, Acoeffs, diagA, out), "cpu", memo))
        return out

    def schur(rhs_p, ainv1=None, mg=None):
        out = solve_s(rhs_p, ainv1=ainv1, mg=mg)
        if rhs_p.dtype == BF16:
            rec["schur"].append(to((rhs_p, out), "cpu", memo))
        return out

    P, M = cuda_stencil.Poisson2DKernel, cuda_stencil.Momentum2DKernel
    call_p, call_m = P.__call__, M.__call__

    def poisson(self, mode, p, c, b=None, w=None, omega=0.0):
        out = call_p(self, mode, p, c, b, w, omega)
        if p.dtype == BF16 and len(rec["poisson2d"]) < KERNEL_CALLS:
            rec["poisson2d"].append(to((mode, p, c, b, w, omega, out), "cpu", memo))
        return out

    def mom(self, W, u, v, periodic):
        out = call_m(self, W, u, v, periodic)
        if u.dtype == BF16 and len(rec["momentum2d"]) < KERNEL_CALLS:
            rec["momentum2d"].append(to((W, u, v, tuple(periodic), out), "cpu", memo))
        return out

    impl._solve_momentum, impl._solve_schur = momentum, schur
    P.__call__, M.__call__ = poisson, mom
    try:
        ns.step()
    finally:
        P.__call__, M.__call__ = call_p, call_m
        del impl._solve_momentum, impl._solve_schur
    rec["fields"] = to((*ns.state["v"], ns.state["p"]), "cpu")
    return rec


def export_poisson(rec, path) -> None:
    """The POISSON_EXPORT calls of ``rec``'s bf16 Poisson calls, which
    share one level's coefficients, as an npz."""
    calls = [rec["poisson2d"][k] for k in POISSON_EXPORT]
    c = calls[0][2]
    if any(not all(torch.equal(getattr(call[2], f), getattr(c, f))
                   for f in ("rx", "ry", "cy", "cyb")) for call in calls):
        raise ValueError("the exported calls must share one level's coefficients")

    def bits(x):
        return x.contiguous().view(torch.int16).numpy()

    out = {"modes": np.array([call[0] for call in calls]),
           "omega": np.array([call[5] for call in calls]),
           "periodic": np.array(c.periodic),
           **{f: getattr(c, f).numpy() for f in ("rx", "ry", "cy", "cyb")}}
    for k, (mode, p, _, b, w, _, res) in enumerate(calls):
        out[f"p{k}"], out[f"out{k}"] = bits(p), bits(res)
        if b is not None:
            out[f"b{k}"] = bits(b)
        if w is not None:
            out[f"w{k}"] = bits(w)
    np.savez_compressed(path, **out)


def dist(a, b) -> float:
    """max |a - b| over a tensor or a tuple of them, in float64."""
    a, b = (a,) if isinstance(a, torch.Tensor) else a, (b,) if isinstance(b, torch.Tensor) else b
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


def size(a) -> float:
    a = (a,) if isinstance(a, torch.Tensor) else a
    return max(float(x.double().abs().max()) for x in a)


def ulps(got, ref):
    """(max |got - ref| in bf16 units in the last place of ref, share of
    cells that differ) over a tensor or a tuple of them."""
    got, ref = (got,) if isinstance(got, torch.Tensor) else got, \
        (ref,) if isinstance(ref, torch.Tensor) else ref
    worst, differ, n = 0.0, 0, 0
    for g, r in zip(got, ref):
        g, r = g.double(), r.double()
        # one unit in the last place of a bf16 value: 2^(exponent - 7)
        unit = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        d = (g - r).abs()
        worst = max(worst, float((d / unit).max()))
        differ += int((d > 0).sum())
        n += r.numel()
    return worst, differ / n


def compare(saved, device):
    """The saved step's calls against this device's (see the module's
    docstring)."""
    ns = solver(device)
    own = record_step(ns)
    impl = ns.impl
    mg = impl._pre_resources()["mg"]
    out = {"fields_max_abs": dist(own["fields"], saved["fields"]), "momentum": [],
           "schur": []}
    for k, (rhs, Ac, dA, res) in enumerate(saved["momentum"]):
        mine = to(own["momentum"][k], device) if k < len(own["momentum"]) else None
        replay = impl._solve_momentum(to(rhs, device), to(Ac, device), to(dA, device))
        out["momentum"].append({
            "result_size": size(res),
            "inputs_apart": None if mine is None else dist(mine[0], rhs),
            "results_apart": None if mine is None else dist(mine[3], res),
            "replay_apart": dist(replay, res)})
    for k, (rhs, res) in enumerate(saved["schur"]):
        mine = to(own["schur"][k], device) if k < len(own["schur"]) else None
        replay = impl._solve_schur(to(rhs, device), mg=mg)
        out["schur"].append({
            "result_size": size(res),
            "inputs_apart": None if mine is None else dist(mine[0], rhs),
            "results_apart": None if mine is None else dist(mine[1], res),
            "replay_apart": dist(replay, res)})
    for name in ("poisson2d", "momentum2d"):
        worst, share = 0.0, 0.0
        for call in saved[name]:
            args = to(call[:-1], device)
            if name == "poisson2d":
                ref = cuda_stencil.poisson2d_plain(*args)
            else:
                ref = cuda_stencil.momentum2d_plain(*args)
            w, s = ulps(call[-1], to(ref, "cpu"))
            worst, share = max(worst, w), max(share, s)
        out[name] = {"calls": len(saved[name]), "max_ulps": worst, "max_share_differing": share}
    return out


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--poisson-calls", default=None)
    args = ap.parse_args(argv)
    if (args.save is None) == (args.compare is None):
        raise SystemExit("give one of --save PATH and --compare PATH")
    device = check_device(args.device)
    if args.save:
        rec = record_step(solver(device))
        torch.save(rec, args.save)
        if args.poisson_calls:
            export_poisson(rec, args.poisson_calls)
        result = {"saved": args.save, **{k: len(rec[k]) for k in
                                         ("momentum", "schur", "poisson2d", "momentum2d")}}
    else:
        result = compare(torch.load(args.compare, weights_only=False), device)
    emit(result, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
