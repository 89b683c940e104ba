"""The bf16 instances of the four stencil kernels and the bf16 pieces
of the reduced-precision ABF preconditioner, on the CPU.

- Each bf16 plain version (the function the bf16 CUDA instance must
  compute: bf16 fields, float32 coefficients and arithmetic, one
  rounding at the store) equals the float32 plain version on the
  upcast inputs, rounded to bf16, bit for bit; the CPU wrappers return
  it; mixed dtypes are refused.
- ``tree_dot`` of bf16 leaves is a float32 sum of the bf16-rounded
  products; ``tree_axpy`` keeps bf16 leaves in bf16.
- The bf16 3-D A-apply of ``_precond_ctx`` against fluca_tpu's float32
  ``apply_A`` at rtol and atol 0.05 (tests/test_precond_tiling.py),
  and the bf16 V-cycle against fluca_tpu's float32 V-cycle at a max
  relative error below 0.1 (examples/validate_bf16_tpu.py): bf16 keeps
  8 bits of mantissa (unit roundoff 3.9e-3), and a V-cycle rounds its
  fields at every level and sweep. Measured: the A-apply's largest
  deviation is 0.030 on outputs up to 5.2; the V-cycle's 7.5e-3 (2-D)
  and 3.7e-3 (3-D). A wrong coefficient or offset shows at O(1).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.ns import tables as JT
from fluca_tpu.ns.bc import BCType as JBC
from fluca_tpu.ns.bc import BoundaryCondition as JCond
from fluca_tpu.ns.bc import zero_velocity_bc as j_wall
from fluca_tpu.ns.operators import NSOperators as JOps
from fluca_tpu.solvers.mg import PoissonMG as JMG
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.ns.bc import BCType as TBC
from fluca_tpu_torch.ns.bc import BoundaryCondition as TCond
from fluca_tpu_torch.ns.bc import zero_velocity_bc as t_wall
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig, CNLinearSolver
from fluca_tpu_torch.ns.operators import NSOperators as TOps
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.solvers.krylov import tree_axpy, tree_dot, tree_scale
from fluca_tpu_torch.solvers.mg import PoissonMG as TMG

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
RHO, MU, DT = 1.0, 0.01, 0.005
# (N, periodic per axis, boundary conditions as (kind per axis))
CASES = {
    "cavity-2d": ((32, 16), (False, False)),
    "periodic-2d": ((16, 32), (True, True)),
    "channel-3d": ((8, 12, 10), (True, False, True)),
    "walls-3d": ((8, 12, 10), (False, False, False)),
}


def meshes(N, periodic, stretched=True):
    """The same mesh and boundary conditions in both packages
    (y stretched where ``stretched``)."""
    faces = [np.linspace(0.0, 1.0, n + 1) for n in N]
    if stretched:
        faces[1] = faces[1] ** 1.3
    out = []
    for Mesh, Cond, Kind, wall in ((JMesh, JCond, JBC, j_wall),
                                   (TMesh, TCond, TBC, t_wall)):
        m = Mesh.create(N, periodic)
        m.set_coordinates(*faces)
        bcs = [Cond(Kind.PERIODIC) if periodic[d] else wall()
               for d in range(len(N)) for _ in range(2)]
        out.append((m, bcs))
    return out


def bf16(rng, shape):
    return torch.tensor(rng.standard_normal(shape), dtype=BF16)


def up(xs):
    return tuple(x.float() for x in xs)


def tree_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------------------
# bf16 plain versions = f32 plain versions on the upcast inputs, rounded
# ----------------------------------------------------------------------

def poisson_case(case):
    N, periodic = CASES[case]
    (_, _), (tm, tb) = meshes(N, periodic)
    mg = TMG(tm, tb, scale=0.25, dtype=BF16, device="cpu")
    lvl = mg.levels[0]
    coef = lvl.coeffs.ry if len(N) == 2 else lvl.coeffs.a0
    assert coef.dtype == F32
    return lvl, len(N)


@pytest.mark.parametrize("mode", sorted(cuda_stencil.POISSON_MODES))
@pytest.mark.parametrize("case", ["cavity-2d", "periodic-2d", "channel-3d",
                                  "walls-3d"])
def test_poisson_bf16_plain_is_rounded_f32(case, mode):
    lvl, dim = poisson_case(case)
    plain = cuda_stencil.poisson2d_plain if dim == 2 else cuda_stencil.poisson3d_plain
    kernel = cuda_stencil.poisson2d if dim == 2 else cuda_stencil.poisson3d
    rng = np.random.default_rng(0)
    p, b = bf16(rng, lvl.mesh.cell_shape), bf16(rng, lvl.mesh.cell_shape)
    assert lvl.inv_diag.dtype == BF16
    args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag, 0.8)}[mode]
    got = plain(mode, p, lvl.coeffs, *args)
    want = plain(mode, p.float(), lvl.coeffs, *up(args[:2]), *args[2:]).to(BF16)
    assert got.dtype == BF16 and torch.equal(got, want)
    assert torch.equal(kernel(mode, p, lvl.coeffs, *args), got)


@pytest.mark.parametrize("periodic", [False, True])
def test_momentum2d_bf16_plain_is_rounded_f32(periodic):
    rng = np.random.default_rng(1)
    W, u, v = bf16(rng, (26, 16, 24)), bf16(rng, (16, 24)), bf16(rng, (16, 24))
    per = (periodic, periodic)
    got = cuda_stencil.momentum2d_plain(W, u, v, per)
    want = tuple(x.to(BF16) for x in cuda_stencil.momentum2d_plain(
        W.float(), u.float(), v.float(), per))
    assert tree_equal(got, want)
    assert tree_equal(cuda_stencil.momentum2d(W, u, v, per), got)


def random_faces(rng, m, dtype):
    def rand(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype)

    U0 = tuple(rand(m.face_shape(d)) for d in range(3))
    v0f = tuple(tuple(rand(m.face_shape(d)) for _ in range(3)) for d in range(3))
    v = tuple(rand(m.cell_shape) for _ in range(3))
    return U0, v0f, v


@pytest.mark.parametrize("case", ["channel-3d", "walls-3d"])
def test_momentum3d_bf16_plain_is_rounded_f32(case):
    N, periodic = CASES[case]
    (_, _), (tm, tb) = meshes(N, periodic)
    ops = TOps(tm, tb, RHO, MU, DT, F64, "cpu")
    U0, v0f, v = random_faces(np.random.default_rng(2), tm, BF16)
    bands = ops.momentum_bands_3d(BF16)
    assert bands.b[0].dtype == F32 and bands is not ops.mom_bands3d
    assert ops.momentum_bands_3d(F32) is bands  # the twin, built once
    f16 = ops.build_momentum_factors_3d(U0, v0f, BF16)
    f32 = ops.build_momentum_factors_3d(U0, v0f, F32)
    assert f16.U0[0].dtype == BF16 and f32.U0[0].dtype == F32
    got = cuda_stencil.momentum3d_plain(bands, f16, v)
    want = tuple(x.to(BF16) for x in cuda_stencil.momentum3d_plain(bands, f32, up(v)))
    assert tree_equal(got, want)
    assert tree_equal(ops.apply_A_coeffs(v, f16), got)  # the factors pick the twin
    # the twin's bands are the solver's, in float32
    for B32, B64 in zip(bands.b, ops.mom_bands3d.b):
        assert torch.equal(B32, B64.float())


def test_bf16_wrappers_refuse_mixed_dtypes():
    N, periodic = CASES["channel-3d"]
    (_, _), (tm, tb) = meshes(N, periodic)
    mg64 = TMG(tm, tb, scale=0.25, dtype=F64, device="cpu")
    mg16 = TMG(tm, tb, scale=0.25, dtype=BF16, device="cpu")
    c64, c32 = mg64.levels[0].coeffs, mg16.levels[0].coeffs
    p = torch.zeros(tm.cell_shape, dtype=BF16)
    with pytest.raises(TypeError):  # bf16 fields take float32 coefficients
        cuda_stencil.poisson3d("apply", p, c64)
    with pytest.raises(TypeError):  # b in another dtype than p
        cuda_stencil.poisson3d("residual", p, c32, p.float())
    with pytest.raises(TypeError):  # no instance takes bf16 coefficients
        cuda_stencil.Poisson3DCoeffs(*(x.to(BF16) for x in (
            c32.a0, c32.c1, c32.c2, c32.h0, c32.h1, c32.h2)), c32.periodic)
    mesh2 = meshes(*CASES["cavity-2d"])[1][0]
    with pytest.raises(TypeError):
        cuda_stencil.Poisson2DCoeffs.from_host(
            [np.ones((3, 32)), np.ones(32), np.ones(16), np.ones((3, 16))],
            mesh2.periodic, BF16, "cpu")
    with pytest.raises(TypeError):  # float32 planes with bf16 fields
        z = torch.zeros((16, 8), dtype=BF16)
        cuda_stencil.momentum2d(torch.zeros((26, 16, 8)), z, z, (False, False))

    ops = TOps(tm, tb, RHO, MU, DT, F64, "cpu")
    U0, v0f, v = random_faces(np.random.default_rng(3), tm, BF16)
    with pytest.raises(TypeError):  # bands in bf16
        cuda_stencil.Momentum3DBands(tuple(B.to(BF16) for B in ops.mom_bands3d.b),
                                     ops.mom_bands3d.periodic)
    with pytest.raises(TypeError):  # bf16 factors for float64 bands
        cuda_stencil.Momentum3DFactors.from_faces(U0, v0f, ops.mom_bands3d, BF16)
    f16 = ops.build_momentum_factors_3d(U0, v0f, BF16)
    with pytest.raises(ValueError):  # bf16 factors with the float64 bands
        cuda_stencil.momentum3d(ops.mom_bands3d, f16, v)
    with pytest.raises(TypeError):  # float32 v with bf16 factors
        ops.apply_A_coeffs(up(v), f16)


def test_every_source_exports_every_instance():
    """Each CUDA source exports one C entry point per field dtype the
    wrappers take (each wrapper binds its own at first launch): the stencil kernels
    f32, f64 and bf16, the chain's stages and the stencils' halo
    instances f32 and f64."""
    for kernel in cuda_stencil.KERNELS:
        src = (cuda_stencil.CSRC_DIR / kernel.source).read_text()
        macro = "CHAIN3D" if kernel.name.startswith("chain3d") else kernel.name.upper()
        exported = set(re.findall(rf"^FLUCA_{macro}_EXPORT\((\w+), ", src, re.M))
        assert exported == set(kernel.instances), kernel.name
    assert {k.name: k.instances for k in cuda_stencil.KERNELS[:4]} == dict.fromkeys(
        ("poisson2d", "momentum2d", "poisson3d", "momentum3d"), ("f32", "f64", "bf16"))
    assert {k.name: k.instances for k in cuda_stencil.KERNELS[7:]} == dict.fromkeys(
        ("poisson2d_halo", "momentum2d_halo", "poisson3d_halo", "momentum3d_halo"),
        ("f32", "f64"))
    assert cuda_stencil.coef_dtype(BF16) == F32
    assert cuda_stencil.coef_dtype(F32) == F32
    assert cuda_stencil.coef_dtype(F64) == F64
    # the 2-D kernels: one marching template each for the unsharded and
    # halo instances, whose entry points take the launch plan; no
    # per-load boundary logic
    for name in ("poisson2d", "momentum2d"):
        src = (cuda_stencil.CSRC_DIR / f"{name}.cu").read_text()
        assert len(re.findall(r"__global__", src)) == 1, name
        assert "load2d" not in src and "Lane2D" in src, name
        for k in (getattr(cuda_stencil, name), getattr(cuda_stencil, f"{name}_halo")):
            assert k.source == f"{name}.cu"
            assert ctypes.POINTER(ctypes.c_int) in k.argtypes, k.name
    assert "load2d" not in (cuda_stencil.CSRC_DIR / "stencil_common.cuh").read_text()


# ----------------------------------------------------------------------
# Krylov tree algebra on bf16 leaves
# ----------------------------------------------------------------------

def test_tree_dot_sums_bf16_products_in_f32():
    rng = np.random.default_rng(4)
    x = (bf16(rng, (64, 64)), bf16(rng, (32,)))
    y = (bf16(rng, (64, 64)), bf16(rng, (32,)))
    d = tree_dot(x, y)
    assert d.dtype == F32
    want = sum(torch.sum((a * b).float()) for a, b in zip(x, y))
    assert torch.equal(d, want)
    exact = sum(float(np.sum(a.double().numpy() * b.double().numpy()))
                for a, b in zip(x, y))
    # float32 sums of the bf16-rounded products: within a few bf16
    # roundoffs of the exact dot product over 4128 terms of O(1)
    assert abs(float(d) - exact) <= 2e-2 * np.sqrt(4128)
    # wider leaves keep torch.dot
    x64 = tuple(a.double() for a in x)
    assert tree_dot(x64, x64).dtype == F64
    # an f32 scalar keeps bf16 vectors in bf16
    assert all(t.dtype == BF16 for t in tree_axpy(d, x, y))
    assert all(t.dtype == BF16 for t in tree_scale(d, x))
    assert torch.equal(tree_axpy(d, x, y)[0], y[0] + d.to(BF16) * x[0])


# ----------------------------------------------------------------------
# against fluca_tpu's float32 A-apply and V-cycle
# ----------------------------------------------------------------------

def test_precond_ctx_bf16_apply_matches_reference_f32():
    """_precond_ctx's bf16 A-apply (a float32 solver, bf16 factors built
    from the step's U0 and v0f) against fluca_tpu's float32 apply_A."""
    N, periodic = (16, 16, 32), (True, False, True)
    (jm, jb), (tm, tb) = meshes(N, periodic, stretched=False)
    cfg = CNLinearConfig.production(2, 2, 2)
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = "mom"
    solver = CNLinearSolver(tm, tb, RHO, MU, DT, cfg=cfg, dtype=F32, device="cpu")
    U0, v0f, v = random_faces(np.random.default_rng(7), tm, F32)
    Acoeffs = solver.ops.build_momentum_operator(U0, v0f)
    ctx = solver._precond_ctx(Acoeffs, solver.ops.diag_A(U0, v0f), U0, v0f)
    f16 = ctx["Acoeffs"]
    assert f16.U0[0].dtype == BF16
    assert solver.ops.momentum_bands_3d(BF16).b[0].dtype == F32
    assert all(d.dtype == BF16 for d in ctx["diagA"])
    got = solver.ops.apply_A_coeffs(tuple(x.to(BF16) for x in v), ctx["Acoeffs"])

    jo = JOps(jm, jb, rho=RHO, mu=MU, dt=DT, dtype=jnp.float32)

    def j(xs):
        return tuple(jnp.asarray(x.numpy()) for x in xs)

    ref = jo.apply_A(j(v), j(U0), tuple(j(r) for r in v0f))
    for c in range(3):
        assert got[c].dtype == BF16
        np.testing.assert_allclose(got[c].float().numpy(), np.asarray(ref[c]),
                                   rtol=0.05, atol=0.05)


@pytest.mark.parametrize("case", ["cavity-2d", "channel-3d"])
def test_bf16_vcycle_matches_reference_f32(case):
    N = {"cavity-2d": (64, 64), "channel-3d": (16, 16, 16)}[case]
    periodic = CASES[case][1]
    (jm, jb), (tm, tb) = meshes(N, periodic)
    jmg = JMG(jm, jb, scale=DT / RHO, dtype=jnp.float32)
    tmg = TMG(tm, tb, scale=DT / RHO, dtype=BF16, device="cpu")
    assert tmg._coarse_pinv.dtype == BF16
    assert tmg._coarse_pinv_acc.dtype == F32
    assert torch.equal(tmg._coarse_pinv_acc, tmg._coarse_pinv.float())
    for lvl in tmg.levels:
        assert (lvl.vol.dtype, lvl.cellvol.dtype, lvl.inv_diag.dtype) == (BF16,) * 3
    b = np.random.default_rng(8).standard_normal(tm.cell_shape).astype(np.float32)
    z32 = np.asarray(jax.jit(jmg.precondition)(jnp.asarray(b)))
    z16 = tmg.precondition(torch.tensor(b).to(BF16))
    assert z16.dtype == BF16
    z16 = z16.float().numpy()
    assert np.isfinite(z16).all()
    rel = np.abs(z16 - z32).max() / np.abs(z32).max()
    assert rel < 0.1, rel
