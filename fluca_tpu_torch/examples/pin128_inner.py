"""The bf16 pin's first step (pin128.py: the 128^2 Re-100 cavity, dt 0.005,
float32 production(3, 8, 6), the bf16 preconditioner on both inner solves)
taken apart call by call, to find where a card's run and a CPU's part;
with ``--case channel32``, the same for one step of a 3-D case: the 32^3
channel from streamwise rolls (dt 2e-3, the same solver), whose bf16 calls reach the 3-D Poisson
kernel in every mode on every multigrid level and the 3-D momentum kernel.

    python -m fluca_tpu_torch.examples.pin128_inner --save PATH [--poisson-calls NPZ]
        [--kernel-calls NPZ] [--case pin128|channel32]
    python -m fluca_tpu_torch.examples.pin128_inner --compare PATH --device cpu
        [--case pin128|channel32]

``--save`` runs the step on ``--device`` (default cuda) and writes every
call of the bf16 momentum and Schur solves (its inputs and result) and of
the bf16 Poisson and momentum kernels (the same; the first KERNEL_CALLS of
each kernel for the pin, the first KEY_CALLS of each kernel key for
channel32) to PATH. ``--compare``
runs the same step on ``--device``, records its own calls, and reports for
each solve call: how far this run's inputs and result lie from the saved
ones, and how far this device's solve, given the saved call's own inputs,
lies from the saved result; and for the kernel calls, the plain version on
each saved call's inputs against the saved output, in bf16 units in the
last place, with the number of cells that part, per kernel and per key
(mode and shape for a Poisson kernel, shape for a momentum kernel). A
kernel that rounds as its plain version does parts from it at no cell; one
that rounds once where the plain version rounds each operation parts by a
unit or so at a few cells; a solve that is the same function gives, from
the same inputs, the same result up to such roundings.
``--poisson-calls`` also writes the bf16 Poisson calls POISSON_EXPORT of
the first Schur solve (one of each mode at 128^2, where the cells' terms
cancel) to a small npz: bf16 fields as their 16 bits, the level's float32
coefficients; tests/test_torch_bf16_witness.py holds the plain version
against such a card's record bit for bit. ``--kernel-calls`` writes the
first bf16 call of each kernel key to a small npz in the same way: for the
pin the first momentum 2-D call, for channel32 the first 3-D Poisson call
of each (mode, level) and the first 3-D momentum call, which the witness
tests replay too. Prints one JSON line.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.examples.pin128 import bf16_both
from fluca_tpu_torch.models.cavity import setup_cavity_2d
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil

BF16 = torch.bfloat16
KERNEL_CALLS = 120  # bf16 kernel calls kept, per kernel (the 2-D pin)
KEY_CALLS = 12  # bf16 kernel calls kept per kernel key (a 3-D case)
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
                                         for f in dataclasses.fields(x) if f.init})
    return x


def solver(device, case="pin128"):
    if case == "pin128":
        ns = setup_cavity_2d(N=128, Re=100.0, dt=0.005, max_steps=10**9,
                             dtype=torch.float32, device=device)
    elif case == "channel32":
        ns = setup_channel_3d(N=(32, 32, 32), dt=2e-3, max_steps=10**9,
                              perturb_mode="rolls", dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown case {case!r} (pin128 or channel32)")
    ns.impl.cfg = bf16_both()
    return ns


# the kernels each case records, by the dimension of its grid
KERNELS = {2: ("poisson2d", "momentum2d"), 3: ("poisson3d", "momentum3d")}


def record_step(ns):
    """The first step of ``ns``, with its bf16 solve and kernel calls on the
    CPU: {"momentum": [(rhs, Acoeffs, diagA, out)], "schur": [(rhs, out)],
    "poisson2d" | "poisson3d": [(mode, p, c, b, w, omega, out)],
    "momentum2d": [(W, u, v, periodic, out)] | "momentum3d": [(bands,
    factors, v, out)]} and the fields after the step."""
    impl = ns.impl
    pname, mname = KERNELS[ns.mesh.dim]
    rec = {"momentum": [], "schur": [], pname: [], mname: []}
    memo = {}
    kept = {}

    def keep(name, call):
        """Whether to record a bf16 call: the first KERNEL_CALLS of each
        kernel in 2-D, the first KEY_CALLS of each kernel key in 3-D."""
        if ns.mesh.dim == 2:
            return len(rec[name]) < KERNEL_CALLS
        key = (name, kernel_key(name, call))
        kept[key] = kept.get(key, 0) + 1
        return kept[key] <= KEY_CALLS
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

    if ns.mesh.dim == 2:
        P, M = cuda_stencil.Poisson2DKernel, cuda_stencil.Momentum2DKernel
    else:
        P, M = cuda_stencil.Poisson3DKernel, cuda_stencil.Momentum3DKernel
    call_p, call_m = P.__call__, M.__call__

    def poisson(self, mode, p, c, b=None, w=None, omega=0.0):
        out = call_p(self, mode, p, c, b, w, omega)
        if p.dtype == BF16 and keep(pname, (mode, p)):
            rec[pname].append(to((mode, p, c, b, w, omega, out), "cpu", memo))
        return out

    def mom2d(self, W, u, v, periodic):
        out = call_m(self, W, u, v, periodic)
        if u.dtype == BF16 and keep(mname, (W, u)):
            rec[mname].append(to((W, u, v, tuple(periodic), out), "cpu", memo))
        return out

    def mom3d(self, bands, f, v):
        out = call_m(self, bands, f, v)
        if v[0].dtype == BF16 and keep(mname, (bands, f, v)):
            rec[mname].append(to((bands, f, tuple(v), out), "cpu", memo))
        return out

    mom = mom2d if ns.mesh.dim == 2 else mom3d

    impl._solve_momentum, impl._solve_schur = momentum, schur
    P.__call__, M.__call__ = poisson, mom
    try:
        ns.step()
    finally:
        P.__call__, M.__call__ = call_p, call_m
        del impl._solve_momentum, impl._solve_schur
    rec["fields"] = to((*ns.state["v"], ns.state["p"]), "cpu")
    return rec


def bits(x):
    """A bf16 tensor's 16 bits as int16."""
    return x.contiguous().view(torch.int16).numpy()


def export_poisson(rec, path) -> None:
    """The POISSON_EXPORT calls of ``rec``'s bf16 Poisson calls, which
    share one level's coefficients, as an npz."""
    calls = [rec["poisson2d"][k] for k in POISSON_EXPORT]
    c = calls[0][2]
    if any(not all(torch.equal(getattr(call[2], f), getattr(c, f))
                   for f in ("rx", "ry", "cy", "cyb")) for call in calls):
        raise ValueError("the exported calls must share one level's coefficients")

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


def kernel_key(name, call) -> str:
    """The key a recorded kernel call is counted under: the mode and
    shape of a Poisson call, the shape of a momentum call."""
    if name.startswith("poisson"):
        return f"{call[0]} {'x'.join(map(str, call[1].shape))}"
    shape = call[1].shape if name == "momentum2d" else call[2][0].shape
    return "x".join(map(str, shape))


def export_kernels(rec, path) -> None:
    """For each kernel key of ``rec`` the bf16 call whose field input has
    the most nonzero cells (the first of those), as an npz: for a 2-D
    record a momentum 2-D call; for a 3-D record a Poisson call of each
    (mode, shape) and a momentum call. bf16 fields as their 16 bits,
    coefficient arrays as float32."""
    def live(calls, field):
        return sorted(calls, key=lambda c: -int((field(c) != 0).sum()))

    out = {}
    if "momentum2d" in rec:
        W, u, v, periodic, (ou, ov) = live(rec["momentum2d"],
                                           lambda c: c[1].abs() + c[2].abs())[0]
        out.update(m2d_W=bits(W), m2d_u=bits(u), m2d_v=bits(v), m2d_out_u=bits(ou),
                   m2d_out_v=bits(ov), m2d_periodic=np.array(periodic))
    else:
        seen = []
        for call in live(rec["poisson3d"], lambda c: c[1]) + rec["poisson3d"]:
            key = kernel_key("poisson3d", call)
            if key in seen:
                continue
            k = len(seen)
            seen.append(key)
            mode, p, c, b, w, omega, res = call
            out[f"p3d_mode{k}"] = np.array(mode)
            out[f"p3d_omega{k}"] = np.array(omega)
            out[f"p3d_periodic{k}"] = np.array(c.periodic)
            for f in ("a0", "c1", "c2", "h0", "h1", "h2"):
                out[f"p3d_{f}{k}"] = getattr(c, f).numpy()
            for f, x in (("p", p), ("b", b), ("w", w), ("out", res)):
                if x is not None:
                    out[f"p3d_{f}{k}"] = bits(x)
        out["p3d_calls"] = np.array(len(seen))
        bands, fac, v, res = live(rec["momentum3d"], lambda c: c[2][0])[0]
        out["m3d_periodic"] = np.array(bands.periodic)
        for a in range(3):
            out[f"m3d_band{a}"] = bands.b[a].numpy()
            out[f"m3d_U0_{a}"] = bits(fac.U0[a])
            out[f"m3d_v{a}"] = bits(v[a])
            out[f"m3d_out{a}"] = bits(res[a])
            for c in range(3):
                out[f"m3d_v0f_{a}{c}"] = bits(fac.v0f[a][c])
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


def parting(got, ref):
    """(cells of ``got`` that differ from ``ref``, cells) over a tensor or
    a tuple of them."""
    got, ref = (got,) if isinstance(got, torch.Tensor) else got, \
        (ref,) if isinstance(ref, torch.Tensor) else ref
    return (sum(int((g.double() != r.double()).sum()) for g, r in zip(got, ref)),
            sum(r.numel() for r in ref))


def kernel_report(name, calls, device):
    """Each recorded call's plain version, on its inputs on ``device``,
    against its recorded output: per kernel key the calls, the cells that
    part and of how many, and the most bf16 units they part by; and the
    same over every call."""
    plain = {"poisson2d": cuda_stencil.poisson2d_plain,
             "momentum2d": cuda_stencil.momentum2d_plain,
             "poisson3d": cuda_stencil.poisson3d_plain,
             "momentum3d": cuda_stencil.momentum3d_plain}[name]
    keys = {}
    worst, share = 0.0, 0.0
    for call in calls:
        ref = to(plain(*to(call[:-1], device)), "cpu")
        w, s = ulps(call[-1], ref)
        d, n = parting(call[-1], ref)
        worst, share = max(worst, w), max(share, s)
        k = keys.setdefault(kernel_key(name, call), {"calls": 0, "cells_differing": 0,
                                                     "cells": 0, "max_ulps": 0.0})
        k["calls"] += 1
        k["cells_differing"] += d
        k["cells"] += n
        k["max_ulps"] = max(k["max_ulps"], w)
    return {"calls": len(calls), "max_ulps": worst, "max_share_differing": share,
            "cells_differing": sum(k["cells_differing"] for k in keys.values()),
            "cells": sum(k["cells"] for k in keys.values()), "by_key": keys}


def compare(saved, device, case="pin128"):
    """The saved step's calls against this device's (see the module's
    docstring)."""
    ns = solver(device, case)
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
    for name in KERNELS[ns.mesh.dim]:
        out[name] = kernel_report(name, saved[name], device)
    return out


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--poisson-calls", default=None)
    ap.add_argument("--kernel-calls", default=None)
    ap.add_argument("--case", default="pin128", choices=("pin128", "channel32"))
    args = ap.parse_args(argv)
    if (args.save is None) == (args.compare is None):
        raise SystemExit("give one of --save PATH and --compare PATH")
    if args.poisson_calls and args.case != "pin128":
        raise SystemExit("--poisson-calls records the pin's 2-D calls (--case pin128)")
    device = check_device(args.device)
    if args.save:
        ns = solver(device, args.case)
        rec = record_step(ns)
        torch.save(rec, args.save)
        if args.poisson_calls:
            export_poisson(rec, args.poisson_calls)
        if args.kernel_calls:
            export_kernels(rec, args.kernel_calls)
        result = {"case": args.case, "saved": args.save,
                  **{k: len(rec[k]) for k in ("momentum", "schur", *KERNELS[ns.mesh.dim])}}
    else:
        result = {"case": args.case,
                  **compare(torch.load(args.compare, weights_only=False), device, args.case)}
    emit(result, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
