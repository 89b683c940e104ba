"""Device time of the 3-D Poisson kernel, the 3-D momentum kernel and the
chain stages at the shapes of the 512x256x256 channel (BASELINE config
#5) and the 128^3 channel, through the wrappers a solver calls: the
Poisson 3-D modes on the finest level in float32, float64 and bf16, on
every level in float32, and its halo call on a (2, 2, 2) grid of the
finest level (edge planes given, the 8 launches alone); the momentum
kernel on the first step's face factors in float32 and in bf16 (built
from U0 and v0f as the bf16 preconditioner builds them); the three chain
stages on the solver's bands in float32 and float64. Random fields from a
seed; each time is the mean of launches captured in a CUDA graph.

    python -m fluca_tpu_torch.examples.kernels512 [--device cuda] [--out PATH]

Run by its path with another checkout's root on PYTHONPATH, it times
that checkout's kernels (built in its own build/), so that two commits
can be timed in turns on one card, one process each (A, B, B, A):

    PYTHONPATH=OTHER_CHECKOUT python fluca_tpu_torch/examples/kernels512.py

Prints one JSON line: ms per call by kernel, shape, instance and mode.
"""

from __future__ import annotations

from pathlib import Path

import torch

import fluca_tpu_torch
from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil as cs
from fluca_tpu_torch.ops.chain3d import Chain3D
from fluca_tpu_torch.parallel.mesh import make_device_grid
from fluca_tpu_torch.parallel.sharded import field_edges, halo_layout
from fluca_tpu_torch.solvers import mg as mg_mod

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
NAMES = {F32: "f32", F64: "f64", BF16: "bf16"}


def graph_ms(fn, calls, replays) -> float:
    """Device ms of one fn() call: ``calls`` calls in a CUDA graph,
    replayed ``replays`` times between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def coeffs_as(c, dtype):
    return cs.Poisson3DCoeffs(*(x.to(dtype) for x in (c.a0, c.c1, c.c2, c.h0, c.h1, c.h2)),
                              c.periodic)


def poisson_modes(c, inv_diag, gen, reps) -> dict:
    """ms per call of each mode, fields in ``inv_diag``'s dtype."""
    p, b = (torch.randn(c.shape, generator=gen, device=c.a0.device).to(inv_diag.dtype)
            for _ in range(2))
    out = {}
    for mode in cs.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, inv_diag)}[mode]
        out[mode] = graph_ms(lambda: cs.poisson3d(mode, p, c, *args, omega=0.8), *reps)
    return out


def halo_modes(lvl, gen, reps) -> dict:
    """ms per call of the halo instance's 8 launches on a (2, 2, 2) grid."""
    layout = halo_layout(make_device_grid(3, [lvl.coeffs.a0.device], shape=(2, 2, 2)), lvl.mesh)
    p, b = (torch.randn(lvl.mesh.N, generator=gen, device=lvl.coeffs.a0.device)
            for _ in range(2))
    edges = field_edges(layout, p)
    out = {}
    for mode in cs.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag)}[mode]
        out[mode] = graph_ms(lambda: cs.poisson3d_halo(mode, p, lvl.coeffs, layout, edges, *args,
                                                       omega=0.8), *reps)
    return out


def chain_stages(chain, gen, reps) -> dict:
    """ms per call of each stage on random fields."""
    dev, dtype = chain.b[0].device, chain.b[0].dtype
    out = {}
    for stage, (ins, _) in cs.CHAIN_STAGES.items():
        groups = []
        for _, kind, count in ins:
            ts = tuple(torch.randn(chain.shape if kind == "cell" else cs._face_shape(
                chain.shape, chain.periodic, e), generator=gen, device=dev, dtype=dtype)
                for e in range(count))
            groups.append(ts[0] if count == 1 else ts)
        kernel = getattr(cs, f"chain3d_{stage}")
        out[stage] = graph_ms(lambda: kernel(chain, *groups), *reps)
        del groups
    return out


def momentum_dtypes(ns, gen, reps) -> dict:
    """ms per call of the momentum kernel on the step's face factors of
    ``ns`` in float32 and bf16, on random v."""
    ops, state = ns.impl.ops, ns.state
    Bv0, bcB = ops.apply_B(state["v"]), ops.bc_B(ns.t)
    v0f = tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(3)) for d in range(3))
    out = {}
    for dtype in (F32, BF16):
        bands = ops.momentum_bands_3d(dtype)
        f = ops.build_momentum_factors_3d(state["U"], v0f, dtype)
        v = tuple(torch.randn(ns.mesh.cell_shape, generator=gen, device=bands.b[0].device)
                  .to(dtype) for _ in range(3))
        out[NAMES[dtype]] = graph_ms(lambda: cs.momentum3d(bands, f, v), *reps)
        del f, v
    return out


def channel(N, dt, device):
    return setup_channel_3d(N=N, dt=dt, stretch_y=2.0, device=device)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    device = check_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("kernels512 times CUDA kernels: it needs a CUDA device")
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"package": str(Path(fluca_tpu_torch.__file__).resolve().parent),
              "poisson3d": {}, "poisson3d_halo": {}, "momentum3d": {}, "chain3d": {}}
    for N, dt, reps in (((512, 256, 256), 5e-5, (10, 10)), ((128, 128, 128), 2e-3, (50, 20))):
        key = "x".join(map(str, N))
        ns = channel(N, dt, device)
        impl = ns.impl
        levels = impl.mg.levels if N[0] == 512 else impl.mg.levels[:1]
        for lvl in levels:
            lkey = "x".join(map(str, lvl.coeffs.shape))
            result["poisson3d"][f"{lkey} f32"] = poisson_modes(lvl.coeffs, lvl.inv_diag, gen, reps)
        lvl = levels[0]
        result["poisson3d"][f"{key} f64"] = poisson_modes(
            coeffs_as(lvl.coeffs, F64), lvl.inv_diag.to(F64), gen, reps)
        lvl16 = mg_mod._build_level(ns.mesh, T_.axis_bcs(ns.mesh, ns.bcs), impl.dt / impl.rho,
                                    BF16, device)
        result["poisson3d"][f"{key} bf16"] = poisson_modes(lvl16.coeffs, lvl16.inv_diag, gen, reps)
        del lvl16
        if N[0] == 512:
            result["poisson3d_halo"][f"{key} on (2, 2, 2) f32"] = halo_modes(lvl, gen, reps)
        result["momentum3d"][key] = momentum_dtypes(ns, gen, reps)
        chain = impl._stages
        twin = Chain3D(impl.mesh, impl.ops.axbcs, impl.rho, impl.dt, F64, device)
        del ns, impl, levels, lvl
        torch.cuda.empty_cache()
        for ch in (chain, twin):
            result["chain3d"][f"{key} {NAMES[ch.b[0].dtype]}"] = chain_stages(ch, gen, reps)
        del chain, twin
        torch.cuda.empty_cache()
    emit(result, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
