"""Device time of the marching 3-D kernels under other launch plans than
their own: the Poisson 3-D kernel (csrc/poisson3d.cu, apply, residual
and smooth) on the three finest multigrid levels of the 512x256x256
channel, and the three chain stages (csrc/chain3d.cu) on its bands and
on the 128^3 channel's, float32, at every (rows, run) of a sweep. Each
launch is held against the wrapper's own launch at max abs difference 0
(a plan moves cells between threads, not the arithmetic); the plans the
wrappers pick (cuda_stencil.poisson3d_launch_plan, chain3d_launch_plan)
are printed beside the sweep.

    python -m fluca_tpu_torch.examples.plans512 [--grid 512x256x256]
        [--device cuda] [--out PATH]

Prints one JSON line: per kernel and shape, the device ms of each
(rows, run) and the wrappers' plans.
"""

from __future__ import annotations

import ctypes

import torch

from fluca_tpu_torch.examples._common import emit, parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.ns import check_device
from fluca_tpu_torch.ops import cuda_stencil as cs

POISSON_ROWS = (4, 8, 16)
POISSON_RUNS = (1, 4, 8, 16, 32, 64)
CHAIN_ROWS = (cs.CHAIN3D_TILE_ROWS,)  # csrc/chain3d.cu refuses another
CHAIN_RUNS = (16, 32, 64)


def graph_ms(fn, calls=10, replays=10) -> float:
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


def march_plan(box, rows, run, smem) -> cs.MarchPlan:
    """The plan of ``rows`` x 32 blocks and ``run`` planes over ``box``."""
    return cs.MarchPlan((-(-box[2] // cs.MARCH_LANES), -(-box[1] // rows), -(-box[0] // run)),
                        rows, run, smem)


def check_same(label, got, ref) -> None:
    for a, b in zip(got, ref):
        if not torch.equal(a, b):
            raise RuntimeError(f"{label}: a plan changed the result")


def poisson_sweep(lvl, gen) -> dict:
    """Each mode of the Poisson 3-D kernel on level ``lvl`` under every
    (rows, run) of the sweep."""
    c, shape = lvl.coeffs, lvl.coeffs.shape
    p, b = (torch.randn(shape, generator=gen, device=c.a0.device) for _ in range(2))
    entry = cs.poisson3d._entry("f32")
    out = {}
    for mode in cs.POISSON_MODES:
        bb = b if mode != "apply" else None
        ww = lvl.inv_diag if mode == "smooth" else None
        ref = cs.poisson3d(mode, p, c, bb, ww, 0.8)

        def launch(plan):
            o = torch.empty_like(p)
            ptrs = [t if t is None else t.data_ptr()
                    for t in (p, bb, ww, c.a0, c.c1, c.c2, c.h0, c.h1, c.h2, o)]
            err = entry(cs.POISSON_MODES[mode], (ctypes.c_void_p * 10)(*ptrs), *shape,
                        *(int(x) for x in c.periodic), 0.8, plan.as_c(),
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"poisson3d: cudaError {err}")
            return o

        times = {}
        for rows in POISSON_ROWS:
            for run in POISSON_RUNS:
                if run > shape[0]:
                    continue
                plan = march_plan(shape, rows, run, 4 * 4 * run)
                check_same(f"poisson3d {mode} {shape}", (launch(plan),), (ref,))
                times[f"rows {rows} run {run}"] = graph_ms(lambda: launch(plan))
        out[mode] = times
    return out


def chain_sweep(chain, gen) -> dict:
    """Each chain stage on ``chain``'s bands under every (rows, run) of
    the sweep."""
    box = cs.chain_face_box(chain.shape, chain.periodic)
    out = {}
    for stage, (ins, _) in cs.CHAIN_STAGES.items():
        kernel = getattr(cs, f"chain3d_{stage}")
        groups = []
        for _, kind, count in ins:
            ts = tuple(torch.randn(chain.shape if kind == "cell" else cs._face_shape(
                chain.shape, chain.periodic, e), generator=gen, device=chain.b[0].device)
                for e in range(count))
            groups.append(ts[0] if count == 1 else ts)
        ref = [t for g in kernel(chain, *groups) for t in ((g,) if torch.is_tensor(g) else g)]
        flat_in = [t for g in groups for t in ((g,) if torch.is_tensor(g) else g)]
        entry = kernel._entry("f32")

        def launch(plan):
            o = [torch.empty_like(t) for t in ref]
            tensors = (*chain.b, *flat_in, *o)
            err = entry((ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors)),
                        *chain.shape, *(int(x) for x in chain.periodic), plan.as_c(),
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{kernel.name}: cudaError {err}")
            return o

        times = {}
        for rows in CHAIN_ROWS:
            for run in CHAIN_RUNS:
                if run > box[0]:
                    continue
                smem = 4 * cs.CHAIN3D_BAND_PITCH * (run + rows + cs.MARCH_LANES) + 4 * run
                plan = march_plan(box, rows, run, smem)
                check_same(f"{kernel.name} {chain.shape}", launch(plan), ref)
                times[f"rows {rows} run {run}"] = graph_ms(lambda: launch(plan))
        out[stage] = times
        del groups, ref, flat_in
    return out


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--grid", default="512x256x256", help="cells, N0xN1xN2")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("plans512 times CUDA kernels: it needs a CUDA device")
    N = tuple(int(n) for n in args.grid.split("x"))
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"grid": list(N), "poisson3d": {}, "chain3d": {}, "plans": {}}
    ns = setup_channel_3d(N=N, dt=5e-5, stretch_y=2.0, device=device)
    for lvl in ns.impl.mg.levels[:3]:
        shape = lvl.coeffs.shape
        key = "x".join(map(str, shape))
        result["poisson3d"][key] = poisson_sweep(lvl, gen)
        result["plans"][f"poisson3d {key}"] = vars(cs.poisson3d_launch_plan(shape, torch.float32))
    chains = {"x".join(map(str, N)): ns.impl._stages}
    del ns
    ns = setup_channel_3d(N=(128, 128, 128), dt=2e-3, stretch_y=2.0, device=device)
    chains["128x128x128"] = ns.impl._stages
    del ns
    for key, chain in chains.items():
        result["chain3d"][key] = chain_sweep(chain, gen)
        result["plans"][f"chain3d {key}"] = vars(cs.chain3d_launch_plan(
            chain.shape, chain.periodic, torch.float32))
        torch.cuda.empty_cache()
    emit(result, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
