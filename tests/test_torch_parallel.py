"""The port's domain-decomposed path (fluca_tpu_torch.parallel, NS.shard,
CNLinearSolver.set_device_grid, PoissonMG.set_device_grid, the app's
-parallel_grid) against fluca_tpu's on the CPU.

The port's shards are boxes of the global tensors on one device, the
counterpart of the reference's 8 virtual CPU devices. Its sharded
kernels do the unsharded kernels' arithmetic in the same order, so a
sharded multigrid V-cycle or time step equals the unsharded one bit for
bit (the step against the unchained one: a sharded 3-D step runs
UnfusedChain, as the reference's does). Against fluca_tpu: the
reference's own tolerances where it compares its sharded path
(tests/test_parallel.py:32: atol 1e-10 on the TGV step;
tests/test_halo.py: 1e-12), and ||port - ref|| <= 1e-10 ||ref|| for a
channel step (tests/test_torch_slice3d.py: the same algorithm in
float64 in another summation order, ~1e-13). The JAX comparisons skip
when fewer than 8 devices exist, as the reference's do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluca_tpu.models.channel import setup_channel_3d as j_channel3d
from fluca_tpu.models.tgv import setup_taylor_green_2d as j_tgv
from fluca_tpu.ns import tables as JT
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu.ops.banded import compose_axis_stencils as j_compose
from fluca_tpu.parallel.halo import halo_exchange as j_halo_exchange
from fluca_tpu.parallel.halo import stencil_apply_sharded as j_stencil_sharded
from fluca_tpu.parallel.mesh import _factor as j_factor
from fluca_tpu.parallel.mesh import make_device_grid as j_grid
from fluca_tpu.parallel.mesh import shard_state
from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.solvers.mg import PoissonMG as JMG
from fluca_tpu.ns.bc import zero_velocity_bc as j_wall
from fluca_tpu_torch import app
from fluca_tpu_torch.interop import state_to_numpy
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.models.cavity import setup_cavity_3d as t_cavity3d
from fluca_tpu_torch.models.channel import setup_channel_3d as t_channel3d
from fluca_tpu_torch.models.tgv import setup_taylor_green_2d as t_tgv
from fluca_tpu_torch.ns.bc import zero_velocity_bc as t_wall
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig
from fluca_tpu_torch.ns.cnlinear import UnfusedChain
from fluca_tpu_torch.ops import cuda_stencil as cs
from fluca_tpu_torch.ops.chain3d import Chain3D
from fluca_tpu_torch.parallel.halo import halo_exchange, neighbor_slabs, stencil_apply_sharded
from fluca_tpu_torch.parallel.mesh import _factor, make_device_grid
from fluca_tpu_torch.solvers.mg import PoissonMG as TMG

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

F64 = torch.float64
CHANNEL = dict(N=(16, 16, 16), dt=2e-3)


def jax_devices8():
    """The reference's 8 virtual devices, or a skip."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def rel(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    num = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in zip(got, want)))
    return num / np.sqrt(sum(np.sum(w * w) for w in want))


def test_factor_and_make_device_grid():
    for n in range(1, 17):
        for dim in (1, 2, 3):
            assert _factor(n, dim) == j_factor(n, dim), (n, dim)
    devices = jax_devices8()
    assert make_device_grid(2, ["cpu"] * 8).shape == j_grid(2, devices).mesh.devices.shape
    assert make_device_grid(3, ["cpu"] * 8).shape == (2, 2, 2)
    one = make_device_grid(2, ["cpu"])
    assert one.shape == (1, 1) and one.size == 1
    grid = make_device_grid(2, ["cpu"], shape=(2, 4))
    assert grid.size == 8 and set(grid.devices) == {torch.device("cpu")}
    assert grid.axis_names == ("gx", "gy")
    assert grid.box(grid.coords(5), (16, 32)) == (slice(8, 16), slice(8, 16))
    assert grid.index((1, 1)) == 5
    with pytest.raises(ValueError, match="not divisible"):
        grid.local_shape((16, 30))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 1"):
        make_device_grid(2, ["cpu", "meta"])


@pytest.mark.parametrize("periodic", [False, True])
def test_neighbor_slabs_and_halo_exchange(periodic):
    """The edge planes of every shard on a (4, 2) grid of a 16^2 field,
    and the ghost-extended blocks against fluca_tpu's halo_exchange
    (tests/test_halo.py:22)."""
    N = 16
    x = np.arange(N * N, dtype=np.float64).reshape(N, N)
    grid = make_device_grid(2, ["cpu"] * 8)
    tx = torch.tensor(x)
    lo, hi = neighbor_slabs(tx, grid, 0, periodic)
    n = N // grid.shape[0]
    for k in range(grid.shape[0]):
        below = x[k * n - 1] if k or periodic else np.zeros(N)
        above = x[((k + 1) * n) % N] if k < grid.shape[0] - 1 or periodic else np.zeros(N)
        assert np.array_equal(lo[k].numpy(), below) and np.array_equal(hi[k].numpy(), above)
    got = halo_exchange(grid, tx, (periodic, periodic))
    jgrid = j_grid(2, jax_devices8())
    xs = jax.device_put(jnp.asarray(x), jgrid.cell_sharding())
    with jgrid.mesh:
        want = j_halo_exchange(jgrid, xs, (periodic, periodic), width=1)
    assert got.shape == want.shape == (N + 2 * 4, N + 2 * 2)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("periodic", [False, True])
def test_stencil_apply_sharded(periodic):
    """The explicit-halo banded apply against fluca_tpu's on the
    composed D@Gst bands of a 32^2 grid (tests/test_halo.py:46)."""
    N = 32
    mesh = JMesh.create((N, N), (periodic,) * 2)
    mesh.set_uniform_coordinates(0, 1, 0, 1)
    bc = JBC.PERIODIC if periodic else JBC.VELOCITY
    bands = [j_compose(JT.div_tables(mesh, d),
                       JT.gst_tables(mesh, d, JT.AxisBC(bc, bc))[0]).as_dict()
             for d in range(2)]
    bands = [{off: np.asarray(w) for off, w in b.items()} for b in bands]
    x = np.random.default_rng(0).standard_normal((N, N))
    got = stencil_apply_sharded(make_device_grid(2, ["cpu"] * 8), bands, torch.tensor(x),
                                (periodic, periodic))
    jgrid = j_grid(2, jax_devices8())
    with jgrid.mesh:
        want = j_stencil_sharded(jgrid, bands, jax.device_put(jnp.asarray(x),
                                                              jgrid.cell_sharding()),
                                 (periodic, periodic))
    assert rel([got], [want]) <= 1e-12


def test_sharded_vcycle():
    """A V-cycle with every level sharded on (4, 2) equals the unsharded
    one bit for bit and fluca_tpu's within 1e-12
    (tests/test_pallas_sharded.py:93); set_device_grid(None) restores the
    unsharded kernels."""
    faces = np.linspace(0.0, 1.0, 65)
    jm, tm = JMesh.create((64, 64)), TMesh.create((64, 64))
    jm.set_coordinates(faces, faces)
    tm.set_coordinates(faces, faces)
    mg = TMG(tm, [t_wall()] * 4, scale=1.0, dtype=F64, device="cpu")
    r = np.random.default_rng(3).standard_normal((64, 64))
    ref = mg.precondition(torch.tensor(r))
    mg.set_device_grid(make_device_grid(2, ["cpu"] * 8))
    assert mg.sharded_levels == ((64, 64), (32, 32))
    got = mg.precondition(torch.tensor(r))
    assert torch.equal(got, ref)
    want = JMG(jm, [j_wall()] * 4, scale=1.0, dtype=jnp.float64).precondition(jnp.asarray(r))
    assert rel([got], [want]) <= 1e-12
    mg.set_device_grid(None)
    assert mg.sharded_levels == () and all(lvl.sharded is None for lvl in mg.levels)


def test_sharded_tgv_step_matches_reference(monkeypatch):
    """One TGV 16^2 step with the solver sharded on (4, 2) against
    fluca_tpu's step sharded over its 8 virtual devices
    (tests/test_parallel.py:32), atol 1e-10; it runs the halo
    versions."""
    ran = set()

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            ran.add(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(cs.poisson2d_halo, "_plain",
                        spy("poisson2d", cs.poisson2d_halo._plain))
    monkeypatch.setattr(cs, "momentum2d_halo_plain",
                        spy("momentum2d", cs.momentum2d_halo_plain))
    tns = t_tgv(N=16, nsteps=1, t_final=0.1, device="cpu", dtype=F64)
    tns.shard(shape=(4, 2))
    assert tns.device_grid.shape == (4, 2)
    got, _ = tns.impl.step(tns.state, 0.0, 0)
    assert ran == {"poisson2d", "momentum2d"}

    jns = j_tgv(N=16, nsteps=1, t_final=0.1)
    grid = j_grid(2, jax_devices8())
    sharded = shard_state(grid, jax.tree_util.tree_map(jnp.copy, jns.state))
    with grid.mesh:
        want, _ = jax.jit(lambda s, t: jns.impl._step_impl(s, t, is_first_step=True))(
            sharded, jnp.asarray(0.0))
    for c in range(2):
        np.testing.assert_allclose(got["v"][c].numpy(), np.asarray(want["v"][c]), atol=1e-10)
    np.testing.assert_allclose(got["p"].numpy(), np.asarray(want["p"]), atol=1e-10)


def test_sharded_channel_step():
    """One production step of the 16^3 channel sharded on (2, 2, 2): bit
    for bit the port's unsharded unchained step, and within 1e-10 of
    fluca_tpu's unsharded (unchained) step."""
    states = {}
    for label in ("unchained", "sharded"):
        ns = t_channel3d(device="cpu", dtype=F64, **CHANNEL)
        ns.impl.cfg = TConfig.production()
        if label == "sharded":
            ns.shard(shape=(2, 2, 2))
            assert ns.impl.mg.sharded_levels == ((16, 16, 16), (8, 8, 8))
        else:
            ns.impl._stages = ns.impl._unfused
        ns.step()
        states[label] = state_to_numpy(ns.state)
    for k in ("v", "U", "p", "phalf"):
        a, b = states["sharded"][k], states["unchained"][k]
        assert all(np.array_equal(x, y) for x, y in zip(
            a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,))), k
    jns = j_channel3d(dtype=jnp.float64, **CHANNEL)
    jns.impl.cfg = JConfig.production()
    jns.step()
    for k in ("v", "U", "p"):
        want = jns.state[k] if isinstance(jns.state[k], tuple) else (jns.state[k],)
        got = states["sharded"][k] if k != "p" else (states["sharded"]["p"],)
        assert rel(got, want) <= 1e-10, k


def test_choices_under_a_grid_and_their_restoration():
    """Under a grid of 8 shards the 3-D solver runs UnfusedChain, the
    sharded momentum kernel and the sharded multigrid levels, and its
    bf16 preconditioner is off; set_device_grid(None) restores Chain3D,
    the unsharded kernels and the bf16 resources."""
    ns = t_cavity3d(N=(8, 8, 8), Re=100.0, dt=0.01, device="cpu", dtype=F64)
    impl = ns.impl
    impl.cfg = TConfig.production()
    impl.cfg.precond_dtype = "bfloat16"
    assert isinstance(impl._stages, Chain3D) and impl._pre_resources() is not None
    ns.shard(shape=(2, 2, 2))
    assert isinstance(impl._stages, UnfusedChain)
    assert impl._pre_resources() is None and impl._pre16 is None
    assert impl.ops.sharded_momentum is not None
    assert impl.mg.sharded_levels == ((8, 8, 8),)
    ns.step()
    assert bool(torch.isfinite(ns.state["p"]).all())
    impl.set_device_grid(None)
    assert ns.device_grid is None and isinstance(impl._stages, Chain3D)
    assert impl.ops.sharded_momentum is None and impl.mg.sharded_levels == ()
    assert impl._pre_resources()["dtype"] == torch.bfloat16


def test_degenerate_grid_keeps_the_kernels():
    """A grid of one shard changes nothing but the recorded grid
    (tests/test_parallel.py:157): the chain, the unsharded kernels and
    the step stay as they were."""
    ns = t_cavity3d(N=(8, 8, 8), Re=100.0, dt=0.01, device="cpu", dtype=F64)
    ns.impl.cfg = TConfig.production()
    ref = t_cavity3d(N=(8, 8, 8), Re=100.0, dt=0.01, device="cpu", dtype=F64)
    ref.impl.cfg = TConfig.production()
    ns.shard()
    assert ns.device_grid.shape == (1, 1, 1)
    assert isinstance(ns.impl._stages, Chain3D)
    assert ns.impl.ops.sharded_momentum is None and ns.impl.mg.sharded_levels == ()
    ns.step()
    ref.step()
    assert torch.equal(ns.state["p"], ref.state["p"])


@pytest.mark.parametrize("argv, grid", [
    (["-cart_grid_x", "16", "-cart_grid_y", "16", "-parallel_grid", "2x2"],
     "{'gx': 2, 'gy': 2}"),
    (["-cart_dim", "3", "-cart_grid_x", "16", "-cart_grid_y", "16", "-cart_grid_z", "16",
      "-parallel_grid", "2x2x2"], "{'gx': 2, 'gy': 2, 'gz': 2}"),
    (["-cart_grid_x", "16", "-cart_grid_y", "16", "-parallel_grid", "auto"],
     "{'gx': 1, 'gy': 1}"),
])
def test_app_parallel_grid(capsys, argv, grid):
    assert app.main(["-device", "cpu", *argv, "-ns_max_steps", "2", "-ns_monitor"]) == 0
    out = capsys.readouterr().out
    assert f"parallel: 1 devices, grid {grid}" in out
    assert "done: CONVERGED_ITS at step 2" in out
