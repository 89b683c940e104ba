"""Checks of a rank-held solver's kernel calls against the one-card form.

A rank of a ``RankGrid`` launches the halo instances on its own block
(``HaloLayout.rank_block``). The one-card shards of a ``DeviceGrid`` run
the same instances on boxes of the global tensors, and those equal the
unsharded kernels bit for bit (``parallel/sharded.py``). So each rank-held
call has an exact reference: the one-card sharded call on the gathered
field, whose box at this rank must match it at max abs 0.

``rank_kernel_checks`` makes each call the solver of ``ns`` makes (the
Poisson modes on every held multigrid level, the momentum apply on the
current step's coefficients) on random fields, gathers the fields, makes
the one-card call, and compares; each call, the rank's and the one-card
one, is also held against its plain version. The unsharded Poisson
kernel on the whole levels that every rank solves (below the held ones,
above the coarsest) is held against its plain version. Every rank of the grid must
call it (the gathers and exchanges are collective).
"""

from __future__ import annotations

import torch

from fluca_tpu_torch.ns.operators import NSOperators
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.parallel.mesh import DeviceGrid
from fluca_tpu_torch.parallel.sharded import (
    build_momentum2d_sharded, build_momentum_sharded, build_poisson_sharded,
)
from fluca_tpu_torch.solvers.mg import _build_level

# max relative difference from the plain version, by field dtype (fused
# multiply-adds on the card; the CPU runs the plain version itself)
PLAIN_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}
# the kernels that round every product and sum as their plain versions
# (csrc/poisson2d.cu): held to them at max abs 0
EXACT = ("poisson2d", "poisson2d_halo")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b),
                                                              min=1e-300))


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _hold_plain(kernel, got, plain, label, tol):
    """``got`` against its plain version; marks the kernel's last key as
    checked where ``got`` came from the card."""
    rel = max(_rel(g, p) for g, p in zip(got, plain))
    if not rel <= tol:
        raise AssertionError(f"{kernel.name} {label}: rel {rel:.3e} from the plain "
                             f"version (bound {tol:g})")
    if kernel.name in EXACT and max(_max_abs(g, p) for g, p in zip(got, plain)) != 0.0:
        raise AssertionError(f"{kernel.name} {label}: not equal to its plain version")
    if got[0].is_cuda:
        kernel.mark_checked()
    return rel


def rank_kernel_checks(ns, seed: int = 0) -> list:
    """Every rank-held kernel call of ``ns``'s solver, in its dtype,
    against the one-card sharded call on the gathered fields (max abs
    over this rank's box, expected 0) and both against their plain
    versions. Returns one record per call: name, label,
    max_abs_vs_one_card, rel_vs_plain."""
    impl, grid, mesh = ns.impl, ns.device_grid, ns.mesh
    if not impl.rank_held:
        raise ValueError("rank_kernel_checks takes a solver on a rank-held grid")
    dev, dtype = impl.device, impl.dtype
    tol = PLAIN_RTOL[dtype]
    one_card = DeviceGrid(grid.shape, (torch.device(dev),) * grid.size)
    gen = torch.Generator(device="cpu").manual_seed(seed * 1000 + grid.rank)
    axbcs = impl.ops.axbcs
    out = []

    def rand(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(dev, dtype)

    def gather(x, m, face=None):
        return grid.gather(x, m.N, m.periodic, face)

    def record(name, label, got, box, plain_rel):
        d = max(_max_abs(a, b) for a, b in zip(got, box))
        out.append({"name": name, "label": label, "max_abs_vs_one_card": d,
                    "rel_vs_plain": plain_rel})

    # the Poisson modes on every held level
    for li, lvl in enumerate(impl.mg.levels[:impl.mg.nheld]):
        m, blk = lvl.mesh, lvl.block
        glvl = _build_level(m, axbcs, impl.dt / impl.rho, dtype, dev)
        p, b = rand(blk.cell_shape), rand(blk.cell_shape)
        w = lvl.inv_diag
        pg, bg, wg = gather(p, m), gather(b, m), gather(w, m)
        for mode in cuda_stencil.POISSON_MODES:
            args = {"apply": (), "residual": (b,), "smooth": (b, w)}[mode]
            gargs = {"apply": (), "residual": (bg,), "smooth": (bg, wg)}[mode]
            f = lvl.sharded[mode]
            edges = f.edges(p)
            got = f.launch(p, edges, *args)
            plain = f.kernel._plain(mode, p, lvl.coeffs, f.layout, edges, *args,
                                    impl.mg.omega)
            label = f"{mode} level {li} {m.N} {dtype}"
            rel = _hold_plain(f.kernel, (got,), (plain,), label, tol)
            g = build_poisson_sharded(one_card, glvl, mode, impl.mg.omega)
            gedges = g.edges(pg)
            gout = g.launch(pg, gedges, *gargs)
            _hold_plain(g.kernel, (gout,), (g.kernel._plain(
                mode, pg, glvl.coeffs, g.layout, gedges, *gargs, impl.mg.omega),),
                f"one-card {label}", tol)
            record(f.kernel.name, label, (got,), (blk.cut(gout),), rel)
    # the whole levels between the held ones and the coarsest, which every
    # rank runs through the unsharded kernel
    kernel = cuda_stencil.poisson2d if mesh.dim == 2 else cuda_stencil.poisson3d
    plain = cuda_stencil.poisson2d_plain if mesh.dim == 2 else cuda_stencil.poisson3d_plain
    for li, lvl in enumerate(impl.mg.levels[impl.mg.nheld:-1], impl.mg.nheld):
        p, b = rand(lvl.mesh.N), rand(lvl.mesh.N)
        for mode in cuda_stencil.POISSON_MODES:
            args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag)}[mode]
            got = kernel(mode, p, lvl.coeffs, *args, omega=impl.mg.omega)
            label = f"{mode} whole level {li} {lvl.mesh.N} {dtype}"
            rel = _hold_plain(kernel, (got,), (plain(mode, p, lvl.coeffs, *args,
                                                     omega=impl.mg.omega),), label, tol)
            out.append({"name": kernel.name, "label": label, "max_abs_vs_one_card": 0.0,
                        "rel_vs_plain": rel})
    # the momentum apply on the step's coefficients
    ops = impl.ops
    st = ns.state
    Bv = ops.apply_B(st["v"])
    bcB = ops.bc_B(ns.t)
    v0f = tuple(tuple(Bv[d][c] + bcB[d][c] for c in range(mesh.dim))
                for d in range(mesh.dim))
    U0 = st["U"]
    U0g = tuple(gather(x, mesh, d) for d, x in enumerate(U0))
    v0fg = tuple(tuple(gather(x, mesh, d) for x in row) for d, row in enumerate(v0f))
    blk = ops.block
    v = tuple(rand(blk.cell_shape) for _ in range(mesh.dim))
    vg = tuple(gather(x, mesh) for x in v)
    label = f"{mesh.N} {dtype}"
    if mesh.dim == 2:
        gops = NSOperators(mesh, ops.bcs, impl.rho, impl.mu, impl.dt, dtype, dev)
        W = ops.build_momentum_coeffs_stacked(U0, v0f)
        Wg = gops.build_momentum_coeffs_stacked(U0g, v0fg)
        record("operators", f"momentum planes {label}", (W,),
               (Wg[(slice(None), *(blk.cells(a) for a in range(2)))],), 0.0)
        sm = ops.sharded_momentum
        ue, ve = sm.edges(v[0]), sm.edges(v[1])
        got = sm.launch(W, *v, ue, ve)
        rel = _hold_plain(cuda_stencil.momentum2d_halo, got,
                          cuda_stencil.momentum2d_halo_plain(W, *v, sm.layout, ue, ve),
                          label, tol)
        gm = build_momentum2d_sharded(one_card, mesh, dtype)
        gue, gve = gm.edges(vg[0]), gm.edges(vg[1])
        gout = gm.launch(Wg, *vg, gue, gve)
        _hold_plain(cuda_stencil.momentum2d_halo, gout,
                    cuda_stencil.momentum2d_halo_plain(Wg, *vg, gm.layout, gue, gve),
                    f"one-card {label}", tol)
    else:
        sm = ops.sharded_momentum
        pre = sm.prep(U0, v0f)
        ve = tuple(sm.edges(x) for x in v)
        got = sm.launch(v, pre, ve)
        rel = _hold_plain(cuda_stencil.momentum3d_halo, got,
                          cuda_stencil.momentum3d_halo_plain(
                              sm.bands, pre.factors, v, sm.layout, ve, pre.face_hi),
                          label, tol)
        gm = build_momentum_sharded(one_card, mesh, axbcs, impl.rho, impl.mu, impl.dt,
                                    dtype)
        gpre = gm.prep(U0g, v0fg)
        gve = tuple(gm.edges(x) for x in vg)
        gout = gm.launch(vg, gpre, gve)
        _hold_plain(cuda_stencil.momentum3d_halo, gout,
                    cuda_stencil.momentum3d_halo_plain(
                        gm.bands, gpre.factors, vg, gm.layout, gve, gpre.face_hi),
                    f"one-card {label}", tol)
    record(f"momentum{mesh.dim}d_halo", label, got, tuple(blk.cut(x) for x in gout), rel)
    return out
