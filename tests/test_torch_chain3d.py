"""The port's fused 3-D chain (fluca_tpu_torch/ops/chain3d.py) against
fluca_tpu's, in float64 on the CPU, where the kernel wrapper takes the
plain version:

- the packed bands against fluca_tpu's build_chain_bands, bit for bit
  on the reference's 21 rows and faces 0..N-1, and the top-face rows
  against the stencils its XLA epilogue applies;
- each stage of chain3d_plain against fluca_tpu's Chain3D in interpret
  mode and against the port's UnfusedChain, for the BC kinds of
  tests/test_chain3d.py on non-uniform grids (rtol 1e-12: one algorithm,
  other summation orders, ~1e-15);
- no band outside the packing for any lo/hi pair of VELOCITY,
  PRESSURE_OUTLET, SYMMETRY and PERIODIC;
- the solver's choice of stages;
- a channel step of the port against fluca_tpu's step with its
  interpret-mode Chain3D.

The reference's Chain3D tiles axis 0 by a divisor of N0 between 2 and 8;
the tests take N0 = 8 or 6 and 2-slab tiles, which keep its interpret
mode short. Run as a script, ``python tests/test_torch_chain3d.py
sensitivity`` prints the 128^3 channel's first-step sensitivity to one
rounding of its initial velocity, fluca_tpu's and the port's (a few
minutes and ~5 GB on the CPU)."""

import ctypes
import itertools
import re
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.models.channel import setup_channel_3d as j_channel3d
from fluca_tpu.ns import tables as JT
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JCond
from fluca_tpu.ns.bc import zero_velocity_bc as j_wall
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu.ops import pallas_chain3d as jchain
from fluca_tpu_torch.interop import state_from_numpy, state_to_numpy
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.models import setup_cavity_2d as t_cavity2d
from fluca_tpu_torch.models import setup_cavity_3d as t_cavity3d
from fluca_tpu_torch.models import setup_channel_3d as t_channel3d
from fluca_tpu_torch.ns import tables as TT
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TCond
from fluca_tpu_torch.ns.bc import zero_velocity_bc as t_wall
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig
from fluca_tpu_torch.ns.cnlinear import UnfusedChain
from fluca_tpu_torch.ns.operators import NSOperators as TOps
from fluca_tpu_torch.ops import chain3d, cuda_stencil

from torch_launch_cover import march3d_cells, march3d_cover
from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

F64 = torch.float64
RHO, MU, DT = 1.3, 0.02, 0.01
RTOL = 1e-12
KINDS = ("channel", "cavity", "outlet")
SHAPES = ((8, 8, 8), (6, 5, 7))
STAGES = ("coupled", "pre", "post")
# the stage comparisons with the reference: every kind at 8^3, and the
# odd shape with the kind that has all three non-periodic BC types (the
# UnfusedChain comparisons of test_no_band_outside_the_packing cover every
# lo/hi pair at the odd shape)
REF_CASES = (*((k, SHAPES[0]) for k in KINDS), ("outlet", SHAPES[1]))


def bcs_of(kind, mod):
    """(periodic, bcs) of a BC kind of tests/test_chain3d.py, in the
    reference's (mod "j") or the port's ("t") bc classes."""
    cond, bct, wall = (JCond, JBC, j_wall) if mod == "j" else (TCond, TBC, t_wall)
    per = cond(bct.PERIODIC)
    out = cond(bct.PRESSURE_OUTLET, pressure=lambda t, c: 0.0)
    sym = cond(bct.SYMMETRY)
    if kind == "channel":
        return (True, False, True), [per, per, wall(), wall(), per, per]
    if kind == "cavity":
        return (False,) * 3, [wall()] * 6
    return (False,) * 3, [wall(), out, wall(), wall(), sym, sym]


def faces_of(N, seed=7):
    """Non-uniform face coordinates, as tests/test_chain3d.py makes them."""
    rng = np.random.default_rng(seed)
    return [np.cumsum(np.r_[0.0, 0.8 + 0.4 * rng.random(n)]) for n in N]


def meshes(kind, N):
    """fluca_tpu's and the port's mesh and bcs of one case."""
    periodic, _ = bcs_of(kind, "j")
    jm, tm = JMesh.create(N, periodic), TMesh.create(N, periodic)
    jm.set_coordinates(*faces_of(N))
    tm.set_coordinates(*faces_of(N))
    return (jm, bcs_of(kind, "j")[1]), (tm, bcs_of(kind, "t")[1])


def random_fields(mesh, stage, seed):
    """The stage's inputs as numpy arrays, in the wrapper's groups."""
    rng = np.random.default_rng(seed)

    def cells():
        return tuple(rng.standard_normal(mesh.cell_shape) for _ in range(3))

    faces = tuple(rng.standard_normal(mesh.face_shape(d)) for d in range(3))
    p = rng.standard_normal(mesh.cell_shape)
    if stage == "coupled":
        return cells(), cells(), faces, p
    return cells(), faces, p


def to_torch(group):
    if isinstance(group, tuple):
        return tuple(torch.tensor(x, dtype=F64) for x in group)
    return torch.tensor(group, dtype=F64)


def to_jax(group):
    if isinstance(group, tuple):
        return tuple(jnp.asarray(x) for x in group)
    return jnp.asarray(group)


def flat(groups):
    out = []
    for g in groups:
        out.extend(g if isinstance(g, tuple) else (g,))
    return [np.asarray(x) for x in out]


def assert_groups_close(got, want, rtol=RTOL):
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())


def port_chain(kind, N):
    _, (tm, tbcs) = meshes(kind, N)
    axbcs = TT.axis_bcs(tm, tbcs)
    return (chain3d.Chain3D(tm, axbcs, RHO, DT, F64, "cpu"),
            UnfusedChain(TOps(tm, tbcs, RHO, MU, DT, F64, "cpu")), tm)


# ----------------------------------------------------------------------
# bands
# ----------------------------------------------------------------------

@pytest.mark.parametrize("N", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_bands_match_reference(kind, N):
    (jm, jbcs), (tm, tbcs) = meshes(kind, N)
    want, host = jchain.build_chain_bands(jm, JT.axis_bcs(jm, jbcs), RHO, DT)
    got = chain3d.build_chain_bands(tm, TT.axis_bcs(tm, tbcs), RHO, DT)
    rows = chain3d.CHAIN_ROWS
    for a in range(3):
        n, nf = tm.N[a], tm.nfaces(a)
        assert got[a].shape == (chain3d.CHAIN_NROWS, nf)
        # the reference's 21 rows on faces 0..N-1, bit for bit
        assert np.array_equal(got[a][:21, :n], want[a]), a
        # the top face N: the stencils the reference's epilogue applies
        top = np.zeros((chain3d.CHAIN_NROWS,))
        if not tm.periodic[a]:
            s_g = host[a]["s_g"]
            for op, st, scale in (("T", host[a]["T"].as_dict(), 1.0),
                                  ("R", host[a]["R"], s_g),
                                  ("Gst", host[a]["Gst"].as_dict(), s_g)):
                for off, w in st.items():
                    top[rows[op][off]] = scale * np.asarray(w)[n]
            assert np.array_equal(got[a][:, n], top), a
        # rows 21-23 hold only top-face entries
        assert not np.any(got[a][21:, :n]), a


def axis_pairs():
    kinds = (TBC.VELOCITY, TBC.PRESSURE_OUTLET, TBC.SYMMETRY)
    return [*itertools.product(kinds, kinds), (TBC.PERIODIC, TBC.PERIODIC)]


@pytest.mark.parametrize("lo, hi", axis_pairs(),
                         ids=lambda b: b.name if hasattr(b, "name") else str(b))
def test_no_band_outside_the_packing(lo, hi):
    """Every lo/hi pair on every axis of a non-uniform grid fits the
    packing, and the kernel's plain version agrees with the banded
    operators there."""
    N = (6, 5, 7)
    per = lo == TBC.PERIODIC
    mesh = TMesh.create(N, (per,) * 3)
    mesh.set_coordinates(*faces_of(N, seed=3))
    bands = chain3d.build_chain_bands(mesh, [TT.AxisBC(lo, hi)] * 3, RHO, DT)
    assert [B.shape for B in bands] == [(24, n if per else n + 1) for n in N]

    def cond(kind):
        return TCond(kind, velocity=lambda t, xs: (0.0, 0.0, 0.0),
                     pressure=lambda t, xs: 0.0)

    bcs = [cond(lo), cond(hi)] * 3
    chain = chain3d.Chain3D(mesh, TT.axis_bcs(mesh, bcs), RHO, DT, F64, "cpu")
    unfused = UnfusedChain(TOps(mesh, bcs, RHO, MU, DT, F64, "cpu"))
    for seed, (stage, method) in enumerate(zip(STAGES, ("coupled", "abf_pre", "abf_post"))):
        tgroups = [to_torch(g) for g in random_fields(mesh, stage, seed)]
        assert_groups_close(chain3d.chain3d_plain(stage, chain.b, chain.periodic, *tgroups),
                            getattr(unfused, method)(*tgroups))


def test_a_band_outside_the_packing_raises(monkeypatch):
    N = (6, 5, 7)
    mesh = TMesh.create(N)
    mesh.set_coordinates(*faces_of(N))
    axbcs = [TT.AxisBC(TBC.VELOCITY, TBC.VELOCITY)] * 3
    grad = TT.grad_cell_tables

    def wide(mesh, d, bc):
        st, lo, hi = grad(mesh, d, bc)
        bands = {**st.as_dict(), 3: np.ones(mesh.N[d])}
        return type(st).from_dict(d, mesh.N[d], False, bands), lo, hi

    monkeypatch.setattr(TT, "grad_cell_tables", wide)
    with pytest.raises(ValueError, match="G band at offset 3"):
        chain3d.build_chain_bands(mesh, axbcs, RHO, DT)


# ----------------------------------------------------------------------
# stages
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_chains():
    """fluca_tpu's interpret-mode Chain3D of each case, built once."""
    out = {}
    for kind, N in REF_CASES:
        (jm, jbcs), _ = meshes(kind, N)
        out[kind, N] = jchain.Chain3D(jm, JT.axis_bcs(jm, jbcs), RHO, DT, jnp.float64,
                                      tile_slabs=2, interpret=True)
    return out


def reference_stage(chain, stage, groups):
    fn = {"coupled": chain.coupled, "pre": chain.abf_pre, "post": chain.abf_post}[stage]
    return fn(*(to_jax(g) for g in groups))


@pytest.mark.parametrize("kind, N", REF_CASES)
def test_stages_match_reference_and_unfused(kind, N, reference_chains):
    chain, unfused, tm = port_chain(kind, N)
    for seed, stage in enumerate(STAGES):
        groups = random_fields(tm, stage, seed)
        tgroups = [to_torch(g) for g in groups]
        got = chain3d.chain3d_plain(stage, chain.b, chain.periodic, *tgroups)
        assert_groups_close(got, reference_stage(reference_chains[kind, N], stage, groups))
        fn = {"coupled": unfused.coupled, "pre": unfused.abf_pre,
              "post": unfused.abf_post}[stage]
        assert_groups_close(got, fn(*tgroups))


def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    chain, _, tm = port_chain("outlet", (6, 5, 7))
    before = [(k.launches, set(k.launched)) for k in cuda_stencil.KERNELS]
    for stage, method in zip(STAGES, ("coupled", "abf_pre", "abf_post")):
        tgroups = [to_torch(g) for g in random_fields(tm, stage, 1)]
        got = getattr(chain, method)(*tgroups)
        want = chain3d.chain3d_plain(stage, chain.b, chain.periodic, *tgroups)
        assert all(np.array_equal(g, w) for g, w in zip(flat(got), flat(want)))
    assert [(k.launches, set(k.launched)) for k in cuda_stencil.KERNELS] == before
    assert [k.name for k in cuda_stencil.KERNELS[4:7]] == [
        "chain3d_coupled", "chain3d_pre", "chain3d_post"]


def test_chain_wrapper_refuses_bad_arguments():
    chain, _, tm = port_chain("channel", (6, 5, 7))
    v, U, p = (to_torch(g) for g in random_fields(tm, "pre", 2))
    with pytest.raises(ValueError, match="takes 3 groups"):
        cuda_stencil.chain3d_pre(chain, v, U)
    with pytest.raises(ValueError, match=r"rU\[1\] must have shape"):
        cuda_stencil.chain3d_pre(chain, v, (U[0], U[0], U[2]), p)
    with pytest.raises(TypeError, match="expected torch.float64"):
        cuda_stencil.chain3d_pre(chain, v, U, p.float())
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_stencil.chain3d_pre(chain, v, U, p.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="3-D mesh"):
        chain3d.Chain3D(TMesh.create((4, 4)), [], RHO, DT, F64, "cpu")


# ----------------------------------------------------------------------
# the chain kernel's launch plan (csrc/chain3d.cu)
# ----------------------------------------------------------------------

CHAIN_PLAN_SHAPES = [(512, 256, 256), (128, 128, 128), (64, 64, 32), (37, 29, 33),
                     (16, 16, 16), (1, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("periodic", list(itertools.product((False, True), repeat=3)))
@pytest.mark.parametrize("shape", CHAIN_PLAN_SHAPES)
def test_chain3d_launch_plan_covers_every_face_box_index_once(shape, periodic, dtype):
    """Every index of the face box (N + 1 faces on a non-periodic axis, N
    on a periodic one) is computed by exactly one thread (thread by thread
    up to 16^2 x 256 indices, by the per-axis maps at every size), within
    the card's grid, block and shared-memory limits; the shared memory
    holds the block's band rows, CHAIN3D_BAND_PITCH per index, and one mask
    per plane of its run."""
    plan = cuda_stencil.chain3d_launch_plan(shape, periodic, dtype)
    box = cuda_stencil.chain_face_box(shape, periodic)
    assert box == tuple(n + (0 if per else 1) for n, per in zip(shape, periodic))
    assert all(np.all(c == 1) for c in march3d_cover(plan, box))
    if np.prod(box) <= 16 * 16 * 256:
        assert np.all(march3d_cells(plan, box) == 1)
    gx, gy, gz = plan.grid
    assert gx < 2**31 and gy <= 65535 and gz <= 65535
    assert plan.rows == cuda_stencil.CHAIN3D_TILE_ROWS == 4
    assert plan.run <= cuda_stencil.CHAIN3D_RUNS[1]
    if shape in ((512, 256, 256), (128, 128, 128)) and periodic == (True, False, True):
        assert plan.run == 32  # the channels' run, the one the H100 ran fastest
    blocks = gx * gy * gz
    assert blocks >= min(cuda_stencil.CHAIN3D_TARGET_BLOCKS, box[0] * gx * gy // 4)
    assert plan.smem == (dtype.itemsize * cuda_stencil.CHAIN3D_BAND_PITCH
                         * (plan.run + plan.rows + 32) + 4 * plan.run)
    assert plan.smem <= cuda_stencil.MAX_SMEM_BYTES
    assert list(plan.as_c()) == [*plan.grid, plan.rows, plan.run, plan.smem]


@pytest.mark.parametrize("shape, periodic", [((2_100_000, 1, 1), (False,) * 3),
                                             ((1, 600_000, 1), (False,) * 3),
                                             ((1, 50_000, 50_000), (True,) * 3),
                                             ((4, 0, 4), (False,) * 3)])
def test_chain3d_launch_plan_refuses_what_cannot_fit(shape, periodic):
    """More runs or row tiles than the grid's z and y extents, a plane of
    2^31 faces or more, an empty axis."""
    with pytest.raises(ValueError):
        cuda_stencil.chain3d_launch_plan(shape, periodic, torch.float32)


def test_chain3d_source_exports_every_instance():
    """csrc/chain3d.cu exports one C entry point per stage and instance of
    the wrappers, each taking the launch plan; the stages are one kernel
    template."""
    src = (cuda_stencil.CSRC_DIR / "chain3d.cu").read_text()
    stages = re.findall(r"^\s*FLUCA_CHAIN3D_STAGE\((\w+), k\w+, SFX, T\)", src, re.M)
    sfxs = re.findall(r"^FLUCA_CHAIN3D_EXPORT\((\w+), \w+\)", src, re.M)
    kernels = (cuda_stencil.chain3d_coupled, cuda_stencil.chain3d_pre, cuda_stencil.chain3d_post)
    assert {f"chain3d_{st}_{sfx}" for st in stages for sfx in sfxs} == {
        f"{k.name}_{sfx}" for k in kernels for sfx in k.instances}
    assert re.search(r'extern "C" int fluca_chain3d_##NAME##_##SFX\(', src)
    assert {k.source for k in kernels} == {"chain3d.cu"}
    assert "chain3d.cu" in cuda_stencil.SOURCES
    assert all(ctypes.POINTER(ctypes.c_int) in k.argtypes for k in kernels)
    assert len(re.findall(r"__global__", src)) == 1


# ----------------------------------------------------------------------
# the solver's stages
# ----------------------------------------------------------------------

class Spy:
    """Records which object ran each stage."""

    def __init__(self, impl):
        self.calls = []
        for owner in {impl._stages, impl._unfused}:
            for name in ("coupled", "abf_pre", "abf_post"):
                fn = getattr(owner, name)
                setattr(owner, name, self._wrap(type(owner).__name__, name, fn))

    def _wrap(self, owner, name, fn):
        def run(*args):
            self.calls.append((owner, name))
            return fn(*args)
        return run

    def owners(self):
        return {name: {o for o, n in self.calls if n == name}
                for name in ("coupled", "abf_pre", "abf_post")}


def spied_step(ns, cfg):
    ns.impl.cfg = cfg
    spy = Spy(ns.impl)
    ns.step()
    return spy.owners()


def test_stage_choice():
    def cavity3d():
        return t_cavity3d(N=(6, 6, 6), Re=100.0, dt=0.01, device="cpu", dtype=F64)

    chain, flat_ = {"Chain3D"}, {"UnfusedChain"}
    ns = cavity3d()
    assert isinstance(ns.impl._stages, chain3d.Chain3D)
    assert spied_step(ns, TConfig.production()) == dict.fromkeys(
        ("coupled", "abf_pre", "abf_post"), chain)
    for schur, upper in (("diag", "id"), ("rowsum", "rowsum")):
        got = spied_step(cavity3d(), TConfig(schur_ainv=schur, upper_ainv=upper,
                                             rtol=1e-3, maxiter=4, schur_maxiter=5,
                                             mom_maxiter=5))
        # with upper_ainv "id" the post stage is the unfused one; else the
        # U update is the ainv branch's own, on T, G and R
        post = flat_ if upper == "id" else set()
        assert got == {"coupled": chain, "abf_pre": flat_, "abf_post": post}, schur
    # the bf16 pre branch runs the chain in 3-D and the banded stages in 2-D
    bf16 = TConfig.production()
    bf16.precond_dtype = "bfloat16"
    assert spied_step(cavity3d(), bf16) == dict.fromkeys(
        ("coupled", "abf_pre", "abf_post"), chain)
    for cfg in (TConfig.production(), bf16):
        ns2 = t_cavity2d(N=8, Re=100.0, dt=0.01, device="cpu", dtype=F64)
        assert ns2.impl._stages is ns2.impl._unfused
        assert spied_step(ns2, cfg) == dict.fromkeys(
            ("coupled", "abf_pre", "abf_post"), flat_), cfg.precond_dtype


# ----------------------------------------------------------------------
# a step end to end
# ----------------------------------------------------------------------

def norm(arrays):
    return np.sqrt(sum(np.sum(np.asarray(a) ** 2) for a in arrays))


def jax_state(ns):
    s = ns.state
    return {"v": tuple(np.asarray(x) for x in s["v"]),
            "U": tuple(np.asarray(x) for x in s["U"]),
            "p": np.asarray(s["p"]), "phalf": np.asarray(s["phalf"])}


def test_channel_step_matches_reference_chain():
    """A production step of the 8^3 channel: the port (its chain)
    against fluca_tpu with its interpret-mode Chain3D in place of the
    banded path (tests/test_chain3d.py:132-150), from the same state.
    rtol 1e-10, as tests/test_torch_slice3d.py: one algorithm in
    float64, other summation orders (~1e-13)."""
    jns = j_channel3d(N=(8, 8, 8), dt=2e-3, max_steps=10, dtype=jnp.float64)
    jns.impl.cfg = JConfig.production()
    jns.impl.ops._chain3d = jchain.Chain3D(
        jns.mesh, JT.axis_bcs(jns.mesh, jns.impl.ops.bcs), jns.rho, jns.impl.dt,
        jnp.float64, tile_slabs=2, interpret=True)
    start = jax_state(jns)
    jns.step()
    want = jax_state(jns)

    tns = t_channel3d(N=(8, 8, 8), dt=2e-3, max_steps=10, device="cpu", dtype=F64)
    tns.impl.cfg = TConfig.production()
    assert isinstance(tns.impl._stages, chain3d.Chain3D)
    tns.state = state_from_numpy(start, "cpu", F64)
    tns.step()
    got = state_to_numpy(tns.state)
    for k in ("v", "U"):
        diff = [g - w for g, w in zip(got[k], want[k])]
        assert norm(diff) <= 1e-10 * norm(want[k]), k
    for k in ("p", "phalf"):
        assert np.linalg.norm(got[k] - want[k]) <= 1e-10 * np.linalg.norm(want[k]), k


# ----------------------------------------------------------------------
# the 128^3 sensitivity witness (a script, not a test)
# ----------------------------------------------------------------------

def sensitivity(N=128):
    """fluca_tpu's and the port's first production step of the channel
    (dt 2e-3, float64, CPU) from the model's state and from that state
    with v moved by one rounding, v (1 + 2^-52): the distance between
    the two results, ||a - b|| / ||b|| over v, over U and over p without
    its volume-weighted mean. The port's step chained (the solver's
    default) and unchained; and the chained against the unchained."""
    torch.set_num_threads(4)
    jns = j_channel3d(N=(N,) * 3, dt=2e-3, dtype=jnp.float64)
    s0 = jax_state(jns)
    s1 = dict(s0, v=tuple(x * (1.0 + 2.0 ** -52) for x in s0["v"]))
    vol = jns.mesh.cell_volumes()

    def rel(a, b):
        return norm([x - y for x, y in zip(a, b)]) / norm(b)

    def dist(a, b):
        def pm(p):
            return p - np.sum(vol * p) / np.sum(vol)
        return (f"v {rel(a['v'], b['v']):.4e}, U {rel(a['U'], b['U']):.4e}, "
                f"p {rel([pm(a['p'])], [pm(b['p'])]):.4e}")

    def reference(state):
        ns = j_channel3d(N=(N,) * 3, dt=2e-3, dtype=jnp.float64)
        ns.impl.cfg = JConfig.production()
        ns.state = {"v": tuple(jnp.asarray(x) for x in state["v"]),
                    "U": tuple(jnp.asarray(x) for x in state["U"]),
                    "p": jnp.asarray(state["p"]), "phalf": jnp.asarray(state["phalf"])}
        ns.step()
        return jax_state(ns), float(ns.last_diag["ksp_rnorm"])

    def port(state, chained):
        ns = t_channel3d(N=(N,) * 3, dt=2e-3, device="cpu", dtype=F64)
        ns.impl.cfg = TConfig.production()
        if not chained:
            ns.impl._stages = ns.impl._unfused
        ns.state = state_from_numpy(state, "cpu", F64)
        ns.step()
        return state_to_numpy(ns.state), float(ns.last_diag["ksp_rnorm"])

    runs = {}
    for label, fn in (("fluca_tpu", reference), ("port unchained", lambda s: port(s, False)),
                      ("port chained", lambda s: port(s, True))):
        for k, s in (("state", s0), ("state moved by one rounding", s1)):
            t0 = time.perf_counter()
            runs[label, k], rn = fn(s)
            print(f"{label}, {k}: ksp_rnorm {rn:.6g} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        print(f"{label}: one rounding moves the step by {dist(runs[label, k], runs[label, 'state'])}",
              flush=True)
    print(f"port chained vs unchained: {dist(runs['port chained', 'state'], runs['port unchained', 'state'])}")
    print(f"port unchained vs fluca_tpu: {dist(runs['port unchained', 'state'], runs['fluca_tpu', 'state'])}")


def ab64(N=64, nsteps=11):
    """The port's channel (dt 2e-3, float64, CPU), nsteps production
    steps chained against unchained, and with R row 0 of axis 1 zeroed
    in the chain's bands against unchained: ||a - b|| / ||b|| over v, U
    and p without its mean, as chip_smoke.py's phase_chain_ab reads them
    on the card."""
    torch.set_num_threads(4)

    def run(stages):
        ns = t_channel3d(N=(N,) * 3, dt=2e-3, device="cpu", dtype=F64)
        ns.impl.cfg = TConfig.production()
        if stages == "unchained":
            ns.impl._stages = ns.impl._unfused
        elif stages == "fault":
            impl = ns.impl
            host = chain3d.build_chain_bands(impl.mesh, impl.ops.axbcs, impl.rho, impl.dt)
            host[1][chain3d.CHAIN_ROWS["R"][0]] = 0.0
            impl._stages.b = tuple(torch.as_tensor(B, dtype=F64) for B in host)
        t0 = time.perf_counter()
        ns.advance(nsteps)
        print(f"{stages}: {nsteps} steps in {time.perf_counter() - t0:.1f} s", flush=True)
        return state_to_numpy(ns.state), ns.mesh.cell_volumes()

    runs = {k: run(k) for k in ("chained", "unchained", "fault")}
    vol = runs["chained"][1]

    def dist(a, b):
        def pm(p):
            return p - np.sum(vol * p) / np.sum(vol)
        return (f"v {norm([x - y for x, y in zip(a['v'], b['v'])]) / norm(b['v']):.4e}, "
                f"U {norm([x - y for x, y in zip(a['U'], b['U'])]) / norm(b['U']):.4e}, "
                f"p {norm([pm(a['p']) - pm(b['p'])]) / norm([pm(b['p'])]):.4e}")

    print(f"chained vs unchained: {dist(runs['chained'][0], runs['unchained'][0])}")
    print(f"R row 0 of axis 1 zeroed vs unchained: {dist(runs['fault'][0], runs['unchained'][0])}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    {"sensitivity": sensitivity, "ab64": ab64}[sys.argv[1]](*(int(x) for x in sys.argv[2:]))
