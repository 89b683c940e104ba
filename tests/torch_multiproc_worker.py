"""One rank of the multi-process tests of fluca_tpu_torch
(tests/test_torch_distributed.py): a gloo process group on the CPU,
joined through a ``file://`` store, with one torch thread.

Run: python torch_multiproc_worker.py <rank> <world> <init file> <case>
<out dir>, where <case> is

- ``step:<model>:<grid>``: the model (``cavity`` 16^2 or ``channel`` 16^3,
  float64, production(), 3 steps) built on this rank's block of a
  rank-held grid of shape ``grid`` (e.g. ``2x2``);
  writes this rank's block of the final state, the gathered state (rank
  0), the shapes of every state tensor the rank holds, and the rank's
  kernel calls against the one-card sharded calls;
- ``mg:<N>:<grid>:<smoother>``: one V-cycle of the rank-held multigrid
  on a stretched wall-bounded 2-D mesh of ``N`` cells, coarsened down to
  16 cells, against the one-process V-cycle's box;
- ``exchange:<grid>``: the halo functions on a 16x12 field;
- ``refusals:<grid>``: the refusals of a rank-held grid (a grid that does
  not split the mesh, or comes after the whole solver was built).

Imports no JAX.
"""

import sys

import numpy as np
import torch

torch.set_num_threads(1)

from fluca_tpu_torch.interop import state_to_numpy  # noqa: E402
from fluca_tpu_torch.models.cavity import setup_cavity_2d  # noqa: E402
from fluca_tpu_torch.models.channel import setup_channel_3d  # noqa: E402
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig  # noqa: E402
from fluca_tpu_torch.parallel import distributed, halo  # noqa: E402
from fluca_tpu_torch.parallel.mesh import make_device_grid  # noqa: E402
from fluca_tpu_torch.parallel.ranks import rank_kernel_checks  # noqa: E402

EXCHANGE_N = (16, 12)
EXCHANGE_PERIODIC = (True, False)


def make_model(name, shape=None):
    """The model of a ``step`` case, built on this rank's block of a
    rank-held grid of ``shape`` (the whole grid in one process if None)."""
    kw = dict(dtype=torch.float64, device="cpu")
    if shape is not None:
        kw["grid"] = make_device_grid(len(shape), shape=shape)
    if name == "cavity":
        ns = setup_cavity_2d(N=16, Re=100.0, dt=0.01, **kw)
    else:
        ns = setup_channel_3d(N=(16, 16, 16), dt=2e-3, **kw)
    ns.impl.cfg = CNLinearConfig.production()
    return ns


def exchange_inputs():
    """The field and the tridiagonal bands of the exchange case (the test
    gives the reference the same)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(EXCHANGE_N)
    bands = [{off: rng.standard_normal(n) for off in (-1, 0, 1)} for n in EXCHANGE_N]
    return x, bands


def grid_shape(text):
    return tuple(int(s) for s in text.split("x"))


def run_step(model, shape, out):
    ns = make_model(model, shape)
    grid = ns.device_grid
    shapes = {f"v{c}": tuple(x.shape) for c, x in enumerate(ns.state["v"])}
    shapes.update({f"U{d}": tuple(x.shape) for d, x in enumerate(ns.state["U"])})
    shapes.update(p=tuple(ns.state["p"].shape), phalf=tuple(ns.state["phalf"].shape))
    ns.advance(3)
    st = state_to_numpy(ns.state)
    arrays = {f"v{c}": a for c, a in enumerate(st["v"])}
    arrays.update({f"U{d}": a for d, a in enumerate(st["U"])})
    arrays.update(p=st["p"], phalf=st["phalf"])
    full = ns.gather_state()
    if full is not None:
        g = state_to_numpy(full)
        arrays.update({f"g_v{c}": a for c, a in enumerate(g["v"])})
        arrays.update({f"g_U{d}": a for d, a in enumerate(g["U"])})
        arrays.update(g_p=g["p"], g_phalf=g["phalf"])
    checks = rank_kernel_checks(ns, seed=11)
    for k, v in shapes.items():
        arrays[f"shape_{k}"] = np.array(v)
    arrays["coords"] = np.array(grid.coords)
    arrays["check_names"] = np.array([c["name"] for c in checks])
    arrays["check_one_card"] = np.array([c["max_abs_vs_one_card"] for c in checks])
    arrays["held_levels"] = np.array([len(ns.impl.mg.sharded_levels)])
    np.savez(out, **arrays)


def run_mg(N, shape, smoother, out):
    from fluca_tpu_torch.mesh.cart import CartMesh
    from fluca_tpu_torch.ns.bc import zero_velocity_bc
    from fluca_tpu_torch.solvers.mg import PoissonMG

    mesh = CartMesh.create(N)
    mesh.set_coordinates(*[np.linspace(0.0, 1.0, n + 1) ** 1.3 for n in N])
    bcs = [zero_velocity_bc()] * 4
    kw = dict(scale=0.7, dtype=torch.float64, device="cpu", coarse_size=16,
              smoother=smoother)
    grid = make_device_grid(2, shape=shape)
    held = PoissonMG(mesh, bcs, grid=grid, **kw)
    whole = PoissonMG(mesh, bcs, **kw)
    blk = grid.block(mesh.N, mesh.periodic)
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(N))
    got = held.precondition(blk.cut(r).contiguous())
    want = blk.cut(whole.precondition(r))
    np.savez(out, max_abs=np.array([float((got - want).abs().max())]),
             scale=np.array([float(want.abs().max())]),
             levels=np.array([lvl.mesh.N for lvl in whole.levels]),
             nheld=np.array([held.nheld]))


def run_exchange(shape, out):
    grid = make_device_grid(2, shape=shape)
    x, bands = exchange_inputs()
    n = grid.local_shape(EXCHANGE_N)
    k = grid.coords
    xb = torch.as_tensor(x[k[0] * n[0]:(k[0] + 1) * n[0], k[1] * n[1]:(k[1] + 1) * n[1]])
    np.savez(out, coords=np.array(k),
             halo1=halo.halo_exchange(grid, xb, EXCHANGE_PERIODIC).numpy(),
             halo2=halo.halo_exchange(grid, xb, EXCHANGE_PERIODIC, width=2).numpy(),
             apply=halo.stencil_apply_sharded(grid, bands, xb, EXCHANGE_PERIODIC).numpy(),
             overlapped=halo.stencil_apply_sharded_overlapped(
                 grid, bands, xb, EXCHANGE_PERIODIC).numpy())


def expect_raise(exc, fn, match):
    try:
        fn()
    except exc as e:
        if match not in str(e):
            raise AssertionError(f"raised {e!r}, expected {match!r} in it") from e
        return
    raise AssertionError(f"did not raise {exc.__name__} ({match})")


def run_refusals(shape, out):
    world = distributed.world_size()
    # a grid of another size than the process group
    expect_raise(ValueError, lambda: make_device_grid(2, shape=(world, 2)),
                 "one rank per shard")
    # a grid that does not split the mesh
    grid = make_device_grid(2, shape=shape)
    expect_raise(ValueError, lambda: setup_cavity_2d(N=15, Re=100.0, dt=0.01,
                                                     dtype=torch.float64, device="cpu",
                                                     grid=grid), "not divisible")
    # a rank-held grid given after the whole solver was built
    ns = setup_cavity_2d(N=16, Re=100.0, dt=0.01, dtype=torch.float64, device="cpu")
    expect_raise(ValueError, lambda: ns.shard(shape=shape), "taken before setup")
    # a device other than this rank's
    expect_raise(ValueError, lambda: make_device_grid(2, devices=["meta"], shape=shape),
                 "this rank's device")
    # per-rank checkpoints wait for their slice
    from fluca_tpu_torch.io.checkpoint import save_checkpoint

    ns = setup_cavity_2d(N=16, Re=100.0, dt=0.01, dtype=torch.float64, device="cpu",
                         grid=grid)
    expect_raise(NotImplementedError, lambda: save_checkpoint(out + ".ck", ns), "item 1b")
    np.savez(out, ok=np.array([1]))


def main():
    rank, world, init_file, case, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    distributed.initialize_distributed(backend="gloo", init_method=f"file://{init_file}",
                                       world_size=world, rank=rank, device="cpu",
                                       timeout_s=120)
    kind, *args = case.split(":")
    out = f"{out_dir}/rank{rank}.npz"
    if kind == "step":
        run_step(args[0], grid_shape(args[1]), out)
    elif kind == "mg":
        run_mg(grid_shape(args[0]), grid_shape(args[1]), args[2], out)
    elif kind == "exchange":
        run_exchange(grid_shape(args[0]), out)
    elif kind == "refusals":
        run_refusals(grid_shape(args[0]), out)
    else:
        raise ValueError(f"unknown case {case!r}")
    distributed.finalize_distributed()
    print(f"rank {rank}/{world}: OK {case}", flush=True)


if __name__ == "__main__":
    main()
