"""The port's multi-process step (fluca_tpu_torch.parallel.distributed,
RankGrid, the rank exchange, NS(grid=) over a process group) on the CPU:
gloo ranks joined through a ``file://`` store in ``tmp_path`` (never a
TCP port: tier-1 runs several pytest workers at once), each a process of
``tests/torch_multiproc_worker.py`` with one torch and one BLAS thread,
waited for with a timeout and killed in a ``finally``, as
``tests/test_multiprocess.py:35-57`` runs the reference's.

Tolerances:
- the rank-held step against the port's one-process (unchained) step:
  max |a - b| <= 1e-13 max(1, max |b|) per field, the reference's bound
  for its two-process cavity (tests/test_multiprocess.py:127-145, atol
  1e-13 on O(1) fields), scaled to the field where it exceeds 1 (the
  channel's u and p are O(100)): the two runs differ only in the order
  of the sums added over the ranks;
- against fluca_tpu's single-process step: ||a - b|| <= 1e-10 ||b||, the
  port's slice tolerance (tests/test_torch_slice.py:39);
- each rank's kernel calls against the one-card sharded call's box on
  the gathered field: max abs 0;
- the rank exchange functions against fluca_tpu's ``parallel/halo.py``
  on its virtual devices (8 in this process, tests/conftest.py:18):
  1e-12, as tests/test_halo.py uses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.models.channel import setup_channel_3d as j_channel
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu.parallel import halo as jhalo
from fluca_tpu.parallel.mesh import make_device_grid as j_grid
from fluca_tpu_torch.interop import cut_state, state_to_numpy
from fluca_tpu_torch.io.checkpoint import _read_fields
from fluca_tpu_torch.parallel import distributed
from fluca_tpu_torch.parallel.mesh import Block

from torch_multiproc_worker import EXCHANGE_N, EXCHANGE_PERIODIC, exchange_inputs, make_model
from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiproc_worker.py")
TIMEOUT_S = 120
STEPS = 3
FIELDS = {"cavity": ("v0", "v1", "U0", "U1", "p", "phalf"),
          "channel": ("v0", "v1", "v2", "U0", "U1", "U2", "p", "phalf")}


def run_ranks(tmp_path, world, case):
    """Start ``world`` worker ranks on ``case``; fail on any rank that fails
    or outlasts the timeout (every rank is killed in the end). Returns each
    rank's output arrays."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    init = tmp_path / "init"
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(init), case,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"rank {r}/{world}: OK {case}" in out, out[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def flat(state):
    st = state_to_numpy(state)
    out = {f"v{c}": a for c, a in enumerate(st["v"])}
    out.update({f"U{d}": a for d, a in enumerate(st["U"])})
    out.update(p=st["p"], phalf=st["phalf"])
    return out


_REFS = {}


def references(model):
    """The port's one-process run (unchained, as a sharded 3-D step runs)
    and fluca_tpu's, STEPS steps each, from the worker's setup; made once
    per module."""
    if model not in _REFS:
        ns = make_model(model)
        ns.impl._stages = ns.impl._unfused
        ns.advance(STEPS)
        if model == "cavity":
            jns = j_cavity(N=16, Re=100.0, dt=0.01, dtype=jnp.float64)
        else:
            jns = j_channel(N=(16, 16, 16), dt=2e-3, dtype=jnp.float64)
        jns.impl.cfg = JConfig.production()
        jns.advance(STEPS)
        jst = {f"v{c}": np.asarray(a) for c, a in enumerate(jns.state["v"])}
        jst.update({f"U{d}": np.asarray(a) for d, a in enumerate(jns.state["U"])})
        jst.update(p=np.asarray(jns.state["p"]), phalf=np.asarray(jns.state["phalf"]))
        _REFS[model] = (ns, flat(ns.state), jst)
    return _REFS[model]


@pytest.mark.parametrize("model,shape", [
    ("cavity", (2, 1)), ("cavity", (2, 2)),
    # the wall-normal split: the last rank along y holds face N of U1
    ("channel", (1, 2, 1)),
    # the periodic split: the ranks wrap along x
    ("channel", (2, 1, 1)),
])
def test_rank_step_matches_one_process_and_reference(tmp_path, model, shape):
    """float64 production(), 3 steps, one rank per block: each rank holds
    its block only (lo + hilast faces), the gathered state equals the
    port's one-process run up to the order of the sums and fluca_tpu's at
    the slice tolerance, and every kernel call of every rank equals the
    one-card sharded call's box at max abs 0."""
    world = int(np.prod(shape))
    outs = run_ranks(tmp_path, world, f"step:{model}:{'x'.join(map(str, shape))}")
    ns, port, ref = references(model)
    mesh = ns.mesh
    for r, out in enumerate(outs):
        k = tuple(int(c) for c in out["coords"])
        n = tuple(N // s for N, s in zip(mesh.N, shape))
        blk = Block(mesh.N, mesh.periodic, tuple(c * m for c, m in zip(k, n)), n,
                    tuple(s > 1 for s in shape))
        # shard locality: the block's cells, its faces lo + hilast
        for name in FIELDS[model]:
            want = blk.face_shape(int(name[1])) if name[0] == "U" else n
            assert tuple(out[f"shape_{name}"]) == tuple(want), (r, name)
            assert out[name].shape == tuple(want), (r, name)
        # the block is its box of the gathered state, bit for bit
        cut = cut_state({"v": tuple(outs[0][f"g_v{c}"] for c in range(mesh.dim)),
                         "U": tuple(outs[0][f"g_U{d}"] for d in range(mesh.dim)),
                         "p": outs[0]["g_p"], "phalf": outs[0]["g_phalf"]}, blk)
        for name in FIELDS[model]:
            got = cut[name[0]][int(name[1])] if name[0] in "vU" else cut[name]
            assert np.array_equal(out[name], got), (r, name)
        # the kernel calls, against the one-card sharded calls
        names = set(out["check_names"])
        assert {f"poisson{mesh.dim}d_halo", f"momentum{mesh.dim}d_halo"} <= names
        assert np.all(out["check_one_card"] == 0.0), dict(zip(out["check_names"],
                                                              out["check_one_card"]))
    # 16^2 is one level (the coarsest, gathered); 16^3 two, the finest held
    assert int(outs[0]["held_levels"][0]) == 1
    g = {name: outs[0][f"g_{name}"] for name in FIELDS[model]}
    for name in FIELDS[model]:
        b = port[name]
        d = np.abs(g[name] - b).max()
        assert d <= 1e-13 * max(1.0, np.abs(b).max()), (name, d)
    for name in FIELDS[model]:
        a, b = g[name], ref[name]
        assert np.linalg.norm(a - b) <= 1e-10 * np.linalg.norm(b), name


@pytest.mark.parametrize("N,shape,smoother,levels,nheld", [
    # held, held, held, then the coarsest gathered from restricted blocks
    ((32, 32), (2, 2), "jacobi", 4, 3),
    # held, held, then a whole level (6 rows on 4 ranks) and the coarsest:
    # the fine residual of odd blocks (3 rows) gathered
    ((24, 24), (4, 1), "jacobi", 4, 2),
    # the Chebyshev bounds from norms added over the ranks
    ((36, 36), (2, 2), "chebyshev", 3, 2),
])
def test_rank_vcycle(tmp_path, N, shape, smoother, levels, nheld):
    """One V-cycle of the rank-held hierarchy against the one-process
    V-cycle's box: max abs 0 with Jacobi smoothing (no sum crosses a rank:
    the restriction, prolongation and gathers move values only); within
    1e-12 of the field with Chebyshev, whose bounds are norms added over
    the ranks."""
    world = int(np.prod(shape))
    outs = run_ranks(tmp_path, world, f"mg:{N[0]}x{N[1]}:{shape[0]}x{shape[1]}:{smoother}")
    for out in outs:
        assert len(out["levels"]) == levels and int(out["nheld"][0]) == nheld
        bound = 0.0 if smoother == "jacobi" else 1e-12 * float(out["scale"][0])
        assert float(out["max_abs"][0]) <= bound


def _jax_reference(shape, width):
    """fluca_tpu's halo functions on the exchange case's field over a grid
    of ``shape`` virtual devices."""
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    grid = j_grid(2, jax.devices()[:n], shape=shape)
    x, bands = exchange_inputs()
    xs = jax.device_put(jnp.asarray(x), grid.cell_sharding())

    def shard(w, axis):
        return jax.device_put(jnp.asarray(w), NamedSharding(grid.mesh, P(grid.axis_names[axis])))

    jb = [{off: shard(w, d) for off, w in b.items()} for d, b in enumerate(bands)]
    with grid.mesh:
        return {"halo": np.asarray(jhalo.halo_exchange(grid, xs, EXCHANGE_PERIODIC, width)),
                "apply": np.asarray(jhalo.stencil_apply_sharded(grid, jb, xs,
                                                                EXCHANGE_PERIODIC)),
                "overlapped": np.asarray(jhalo.stencil_apply_sharded_overlapped(
                    grid, jb, xs, EXCHANGE_PERIODIC))}


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_rank_halo_functions_match_reference(tmp_path, shape):
    """halo_exchange (widths 1 and 2), stencil_apply_sharded and
    stencil_apply_sharded_overlapped over 2 and 4 ranks: each rank's result
    is its box of fluca_tpu's on as many virtual devices."""
    outs = run_ranks(tmp_path, int(np.prod(shape)), f"exchange:{'x'.join(map(str, shape))}")
    n = tuple(N // s for N, s in zip(EXCHANGE_N, shape))
    for width in (1, 2):
        ref = _jax_reference(shape, width)
        for out in outs:
            k = tuple(int(c) for c in out["coords"])
            box = tuple(slice(c * (m + 2 * width), (c + 1) * (m + 2 * width))
                        for c, m in zip(k, n))
            np.testing.assert_allclose(out[f"halo{width}"], ref["halo"][box], rtol=0,
                                       atol=1e-12)
    for out in outs:
        k = tuple(int(c) for c in out["coords"])
        box = tuple(slice(c * m, (c + 1) * m) for c, m in zip(k, n))
        for name in ("apply", "overlapped"):
            np.testing.assert_allclose(out[name], ref[name][box], rtol=0, atol=1e-12)
        np.testing.assert_allclose(out["overlapped"], out["apply"], rtol=0, atol=1e-12)


def test_rank_refusals(tmp_path, monkeypatch):
    """No fallback: nccl with ranks that share a card raises before any
    group is joined, naming gloo; a backend must be named; over two ranks
    a grid of another size, a mesh the grid does not split and another
    device than the rank's each raise; a per-shard checkpoint without its
    manifest raises IOError, and over two ranks an explicit "native" save,
    a manifest that lost a record and a checkpoint of another grid each
    raise."""
    monkeypatch.setattr(distributed, "_device", None)
    for dev in ("cuda:0", None):
        with pytest.raises(ValueError, match="gloo"):
            distributed.initialize_distributed(
                backend="nccl", init_method=f"file://{tmp_path / 'never'}", world_size=2,
                rank=1, device=dev)
    with pytest.raises(ValueError, match="name the backend"):
        distributed.initialize_distributed(init_method=f"file://{tmp_path / 'never'}",
                                           world_size=2, rank=0, device="cpu")
    assert not (tmp_path / "never").exists()
    assert distributed._device is None
    with pytest.raises(IOError, match="no manifest of process 0"):
        _read_fields(str(tmp_path), {"format": "sharded", "nprocs": 1})
    run_ranks(tmp_path, 2, "refusals:2x1")


def test_single_process_needs_nothing(monkeypatch):
    """Without an init method or a launcher the run is one process:
    nothing is joined, and process_info has the reference's four keys."""
    monkeypatch.setattr(distributed, "_device", None)
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed(device="cpu") == torch.device("cpu")
    assert distributed.initialize_distributed(device="cuda:5") == torch.device("cpu")
    assert distributed.process_info() == {"process_index": 0, "process_count": 1,
                                          "local_devices": 1, "global_devices": 1}
    assert distributed.world_size() == 1


def test_block_owns_faces_lo_hilast():
    """Every face of an axis lies on exactly one block: lo + hilast on a
    wall axis (the last block holds face N), n per block on a periodic
    one; a block cuts a field to its box."""
    N, periodic = (8, 12), (False, True)
    owned = {0: [], 1: []}
    for k0 in range(2):
        for k1 in range(3):
            blk = Block(N, periodic, (4 * k0, 4 * k1), (4, 4), (True, True))
            for a in range(2):
                f = blk.faces(a)
                owned[a] += list(range(f.start, f.stop))
            assert blk.face_shape(0) == (5 if k0 == 1 else 4, 4)
            assert blk.face_shape(1) == (4, 4)
    assert sorted(owned[0]) == sorted(list(range(9)) * 3)
    assert sorted(owned[1]) == sorted(list(range(12)) * 2)
    x = np.arange(9 * 12).reshape(9, 12)
    blk = Block(N, periodic, (4, 8), (4, 4), (True, True))
    assert np.array_equal(blk.cut(x, face=0), x[4:9, 8:12])
    whole = Block.whole(N, periodic)
    assert whole.face_shape(0) == (9, 12) and whole.face_shape(1) == (8, 12)
