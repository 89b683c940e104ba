"""The port's bf16 inner solves against fluca_tpu's own bf16 code, run
one operation at a time.

fluca_tpu cannot compile a bf16 step on the CPU (tests/test_bf16_precond.py),
but under ``jax.disable_jit`` each operation is a program of its own,
compiled at once and rounded to bf16 at its output, as the port rounds
each torch operation. That makes the reference's own code a witness of
its algorithm at the port's rounding: a fault in the port's bf16 path
would part the two, a property of the algorithm would not.

The tests hold the two packages' bf16 inner solves, the reduced-precision
preconditioner's two parts, on the same right-hand side of the 128^2
cavity (dt 0.005, as the reference's bf16 accuracy pin,
examples/tune_budget_tpu.py) against the exact float64 solution, as
||x - exact|| / ||exact||:

- the Schur solve, production's 6 CG iterations over the bf16 PoissonMG
  with the constant-nullspace projection. Measured (CPU): port 5.3e-3
  (random rhs) and 2.9e-3 (smooth rhs), reference 1.0e-2 and 1.9e-2;
  float32 ~3e-7 in both. The port's kernels read float32 coefficients
  and sum in float32, where the reference's banded path on bf16 tables
  rounds each product and sum;
- the momentum solve, production's 8 BiCGStab iterations with the bf16
  A-apply, at a random state of CFL ~0.6. Measured (CPU): port 5.3e-3,
  reference 6.9e-3; in float32 3.2e-6, the two 1.4e-7 apart.

Bound: the port's bf16 error is at most 1.5 times the reference's own on
the same solve (the rounding order differs); in float32 the Schur solves
are within 1e-5 of the exact solution and the two momentum solves within
1e-5 of each other.

Run as a script, it prints the whole-step readings that PERF.md cites
(each takes a few minutes; the reference's bf16 run is the slow part):

    python tests/test_torch_bf16_witness.py pin
        the reference's bf16 accuracy pin, 50 steps of the 128^2 cavity,
        max |dev| over u, v and p from the converged FGMRES solve: the
        reference's code op by op, and the port (with 1, 2 and 4 torch
        threads: the spread that the order of the sums alone gives), both
        on the CPU
    python tests/test_torch_bf16_witness.py cavity256
        |u|max and ksp_rnorm of the first 22 steps of the 256^2 cavity at
        dt 0.01 with bf16 on both inner solves, in both packages
"""

if __name__ == "__main__":  # run as a script: the settings of conftest.py
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu_torch.models.cavity import setup_cavity_2d as t_cavity
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
N, DT = 128, 0.005
WORSE_BY = 1.5
F32_BOUND = 1e-5


def bf16_production(Config):
    cfg = Config.production(3, 8, 6)
    cfg.precond_dtype = "bfloat16"
    return cfg


def rel(got, exact) -> float:
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - exact) / np.linalg.norm(exact))


def schur_rhs(kind):
    """A compatible (zero-mean) rhs of the pressure problem, from a seed."""
    rng = np.random.default_rng(0)
    if kind == "random":
        rhs = rng.standard_normal((N, N))
    else:
        x = np.linspace(0.0, 1.0, N)
        rhs = (np.sin(3 * np.pi * x)[:, None] * np.cos(2 * np.pi * x)[None, :]
               + 0.01 * rng.standard_normal((N, N)))
    return rhs - rhs.mean()


@functools.lru_cache(maxsize=None)
def solvers():
    """(port float32, reference float32, port float64 to tolerance), the
    first two with bf16 on both inner solves."""
    port = t_cavity(N=N, Re=100.0, dt=DT, device="cpu", dtype=F32).impl
    port.cfg = bf16_production(TConfig)
    ref = j_cavity(N=N, Re=100.0, dt=DT, dtype=jnp.float32).impl
    ref.cfg = bf16_production(JConfig)
    exact = t_cavity(N=N, Re=100.0, dt=DT, device="cpu", dtype=F64).impl
    exact.cfg = TConfig(schur_rtol=1e-13, schur_maxiter=2000, mom_rtol=1e-13,
                        mom_maxiter=2000)
    return port, ref, exact


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_bf16_schur_solve_against_reference(kind):
    port, ref, exact = solvers()
    rhs = schur_rhs(kind)
    want = exact._solve_schur(torch.tensor(rhs)).numpy()
    got16 = port._solve_schur(torch.tensor(rhs).to(BF16),
                              mg=port._pre_resources()["mg"])
    with jax.disable_jit():
        ref16 = ref._solve_schur(jnp.asarray(rhs, jnp.bfloat16),
                                 mg=ref._pre_resources()["mg"])
    assert got16.dtype == BF16 and ref16.dtype == jnp.bfloat16
    port_err = rel(got16.float().numpy(), want)
    ref_err = rel(np.asarray(ref16, np.float64), want)
    assert port_err <= WORSE_BY * ref_err, (port_err, ref_err)
    got32 = port._solve_schur(torch.tensor(rhs, dtype=F32))
    ref32 = ref._solve_schur(jnp.asarray(rhs, jnp.float32))
    assert rel(got32.numpy(), want) <= F32_BOUND
    assert rel(np.asarray(ref32), want) <= F32_BOUND


def random_step_fields(mesh):
    """U0 and v0f of O(1) (a CFL of ~0.6 at dt 0.005), and a momentum
    rhs, from a seed."""
    rng = np.random.default_rng(1)
    U0 = tuple(0.5 * rng.standard_normal(mesh.face_shape(d)) for d in range(2))
    v0f = tuple(tuple(0.5 * rng.standard_normal(mesh.face_shape(d)) for _ in range(2))
                for d in range(2))
    rhs = tuple(rng.standard_normal(mesh.cell_shape) for _ in range(2))
    return U0, v0f, rhs


def test_bf16_momentum_solve_against_reference():
    port, ref, exact = solvers()
    U0, v0f, rhs = random_step_fields(port.mesh)

    def t(xs, dtype):
        return tuple(torch.tensor(x, dtype=dtype) for x in xs)

    def j(xs, dtype):
        return tuple(jnp.asarray(x, dtype) for x in xs)

    tU0, tv0f = t(U0, F64), tuple(t(r, F64) for r in v0f)
    want = exact._solve_momentum(
        t(rhs, F64), exact.ops.build_momentum_operator(tU0, tv0f),
        exact.ops.diag_A(tU0, tv0f))
    want = np.stack([x.numpy() for x in want])

    tU0, tv0f = t(U0, F32), tuple(t(r, F32) for r in v0f)
    Ac, dA = port.ops.build_momentum_operator(tU0, tv0f), port.ops.diag_A(tU0, tv0f)
    ctx = port._precond_ctx(Ac, dA, tU0, tv0f)
    got16 = port._solve_momentum(t(rhs, BF16), ctx["Acoeffs"], ctx["diagA"])
    got32 = port._solve_momentum(t(rhs, F32), Ac, dA)

    jU0, jv0f = j(U0, jnp.float32), tuple(j(r, jnp.float32) for r in v0f)
    Ac, dA = ref.ops.build_momentum_coeffs(jU0, jv0f), ref.ops.diag_A(jU0, jv0f)
    jctx = ref._precond_ctx(Ac, dA, U0=jU0, v0f=jv0f)
    with jax.disable_jit():
        ref16 = ref._solve_momentum(j(rhs, jnp.bfloat16), jctx["Acoeffs"],
                                    jctx["diagA"], applyA=jctx["applyA"])
    ref32 = ref._solve_momentum(j(rhs, jnp.float32), Ac, dA)

    assert {x.dtype for x in got16} == {BF16}
    assert {x.dtype for x in ref16} == {jnp.dtype(jnp.bfloat16)}
    port_err = rel(np.stack([x.float().numpy() for x in got16]), want)
    ref_err = rel(np.stack([np.asarray(x, np.float64) for x in ref16]), want)
    assert port_err <= WORSE_BY * ref_err, (port_err, ref_err)
    # in float32 the two packages run the same iterations to roundoff
    got32, ref32 = (np.stack([np.asarray(x, np.float64) for x in xs])
                    for xs in (got32, ref32))
    assert rel(got32, ref32) <= F32_BOUND


# ----------------------------------------------------------------------
# the pin's first step: the card's bf16 Poisson calls
# ----------------------------------------------------------------------

# Four bf16 calls of the 2-D Poisson kernel in the pin's first Schur solve
# (a smooth, the first apply, a smooth and a residual at 128^2, where the
# cells' terms cancel), recorded on an H100 by
# fluca_tpu_torch/examples/pin128_inner.py --save ... --poisson-calls.
CARD_POISSON_CALLS = Path(__file__).resolve().parent / "torch_data" / \
    "pin128_poisson2d_bf16_h100.npz"


def test_torch_pin_poisson2d_bf16_equals_card():
    """The plain version of the 2-D Poisson kernel, on the card's recorded
    inputs, gives the card's recorded outputs at max abs difference 0. A
    kernel that sums with fused multiply-adds, where the plain version
    rounds each product, fails here: on such a record the two part by a
    bf16 unit at up to a fifth of the cells (the apply of a smooth p),
    which moved the pin's first step on the card 0.53 U from the CPU's,
    and its 50-step reading to 2.9557e-02 U, outside the CPU's spread."""
    from fluca_tpu_torch.ops import cuda_stencil

    z = np.load(CARD_POISSON_CALLS)
    c = cuda_stencil.Poisson2DCoeffs(*(torch.as_tensor(z[f]) for f in ("rx", "ry", "cy", "cyb")),
                                     tuple(bool(x) for x in z["periodic"]))

    def field(key):
        return torch.from_numpy(z[key]).view(BF16) if key in z else None

    for k, mode in enumerate(z["modes"]):
        got = cuda_stencil.poisson2d(str(mode), field(f"p{k}"), c, field(f"b{k}"),
                                     field(f"w{k}"), float(z["omega"][k]))
        card = field(f"out{k}")
        differ = (got.double() != card.double())
        assert not bool(differ.any()), \
            f"call {k} ({mode}): {float(differ.double().mean()):.4f} of the cells differ"


# ----------------------------------------------------------------------
# the card's 2-D momentum and 3-D bf16 calls
# ----------------------------------------------------------------------

# The bf16 momentum 2-D call of the pin's first step with the most nonzero
# cells of u and v (pin128_inner.py --save ... --kernel-calls), and the bf16
# calls of one step of the 32^3 channel from streamwise rolls with the bf16
# preconditioner on both inner solves (pin128_inner.py --case channel32
# --save ... --kernel-calls): a 3-D Poisson call of each (mode, level) that
# the step launches and a 3-D momentum call, recorded on an H100.
CARD_MOMENTUM2D_CALL = Path(__file__).resolve().parent / "torch_data" / \
    "pin128_momentum2d_bf16_h100.npz"
CARD_3D_CALLS = Path(__file__).resolve().parent / "torch_data" / \
    "channel32_bf16_3d_h100.npz"
# the recorded (mode, level) keys of the 3-D Poisson calls, in their order
CARD_POISSON3D_KEYS = ("smooth 32x32x32", "residual 32x32x32", "apply 32x32x32",
                       "residual 16x16x16", "smooth 16x16x16")


def _bf16(z, key):
    return torch.from_numpy(z[key]).view(BF16) if key in z else None


def _assert_bit_equal(got, card, label):
    for k, (g, c) in enumerate(zip(got, card)):
        differ = g.double() != c.double()
        assert not bool(differ.any()), \
            f"{label} output {k}: {int(differ.sum())} of {differ.numel()} cells differ"


def test_torch_pin_momentum2d_bf16_equals_card():
    """The plain version of the 2-D momentum kernel gives the card's
    recorded bf16 output at max abs difference 0. The kernel sums with
    fused multiply-adds, but a product of two bf16 values is exact in
    float32, so each fused step rounds as the plain version's float32 sum
    does: 0 of the 1,572,864 cells of the pin's first step's 48 recorded
    calls parted, before and after the 3-D kernels' bf16 rounding order
    changed (examples/pin128_inner.py --compare)."""
    from fluca_tpu_torch.ops import cuda_stencil

    z = np.load(CARD_MOMENTUM2D_CALL)
    got = cuda_stencil.momentum2d(_bf16(z, "m2d_W"), _bf16(z, "m2d_u"), _bf16(z, "m2d_v"),
                                  tuple(bool(x) for x in z["m2d_periodic"]))
    assert bool(_bf16(z, "m2d_u").abs().max() > 0) and bool(_bf16(z, "m2d_v").abs().max() > 0)
    _assert_bit_equal(got, (_bf16(z, "m2d_out_u"), _bf16(z, "m2d_out_v")), "momentum2d")


@pytest.mark.parametrize("k", range(len(CARD_POISSON3D_KEYS)), ids=CARD_POISSON3D_KEYS)
def test_torch_channel32_poisson3d_bf16_equals_card(k):
    """The plain version of the 3-D Poisson kernel, on the card's recorded
    bf16 call of each mode on each multigrid level that the step launches,
    gives the card's output at max abs difference 0. The bf16 instance
    rounds every product and sum on its own in the plain version's order
    (csrc/stencil_common.cuh kPlainOrder); with the fused multiply-adds it
    had before, 495 of 1,277,952 cells of the step's 60 recorded calls
    parted, by up to 844 bf16 units where the terms cancel (462 cells of
    the applies)."""
    from fluca_tpu_torch.ops import cuda_stencil

    z = np.load(CARD_3D_CALLS)
    assert int(z["p3d_calls"]) == len(CARD_POISSON3D_KEYS)
    c = cuda_stencil.Poisson3DCoeffs(
        *(torch.as_tensor(z[f"p3d_{f}{k}"]) for f in ("a0", "c1", "c2", "h0", "h1", "h2")),
        tuple(bool(x) for x in z[f"p3d_periodic{k}"]))
    mode = str(z[f"p3d_mode{k}"])
    p = _bf16(z, f"p3d_p{k}")
    assert f"{mode} {'x'.join(map(str, p.shape))}" == CARD_POISSON3D_KEYS[k]
    got = cuda_stencil.poisson3d(mode, p, c, _bf16(z, f"p3d_b{k}"), _bf16(z, f"p3d_w{k}"),
                                 float(z[f"p3d_omega{k}"]))
    _assert_bit_equal((got,), (_bf16(z, f"p3d_out{k}"),), f"poisson3d {CARD_POISSON3D_KEYS[k]}")


def test_torch_channel32_momentum3d_bf16_equals_card():
    """The plain version of the 3-D momentum kernel, on the card's recorded
    bf16 call (bf16 v and face factors, float32 bands), gives the card's
    output at max abs difference 0: the bf16 instance rounds in the plain
    version's order. With fused multiply-adds 30 of 1,179,648 cells of the
    step's 12 recorded calls parted, by up to 2 bf16 units."""
    from fluca_tpu_torch.ops import cuda_stencil

    z = np.load(CARD_3D_CALLS)
    periodic = tuple(bool(x) for x in z["m3d_periodic"])
    bands = cuda_stencil.Momentum3DBands(tuple(torch.as_tensor(z[f"m3d_band{a}"])
                                               for a in range(3)), periodic)
    U0 = tuple(_bf16(z, f"m3d_U0_{a}") for a in range(3))
    v0f = tuple(tuple(_bf16(z, f"m3d_v0f_{a}{c}") for c in range(3)) for a in range(3))
    f = cuda_stencil.Momentum3DFactors.from_faces(U0, v0f, bands, BF16)
    v = tuple(_bf16(z, f"m3d_v{a}") for a in range(3))
    assert all(bool(x.abs().max() > 0) for x in v)
    got = cuda_stencil.momentum3d(bands, f, v)
    _assert_bit_equal(got, tuple(_bf16(z, f"m3d_out{a}") for a in range(3)), "momentum3d")


# ----------------------------------------------------------------------
# the whole-step readings (script mode)
# ----------------------------------------------------------------------

def _fields(state):
    return [np.asarray(x, np.float64) for x in (*state["v"], state["p"])]


def pin():
    def ref_run(cfg, eager):
        ns = j_cavity(N=N, Re=100.0, dt=DT, max_steps=60, dtype=jnp.float32)
        ns.impl.cfg = cfg
        if eager:
            with jax.disable_jit():
                ns.advance(50)
        else:
            ns.advance(50)
        return _fields(ns.state)

    def port_run(cfg):
        ns = t_cavity(N=N, Re=100.0, dt=DT, device="cpu", dtype=F32)
        ns.impl.cfg = cfg
        ns.advance(50)
        return _fields(ns.state)

    converged = ref_run(JConfig(), eager=False)
    for label, got in (
        ("reference f32 production(3, 8, 6)", lambda: ref_run(JConfig.production(3, 8, 6), False)),
        ("reference bf16 (both), op by op", lambda: ref_run(bf16_production(JConfig), True)),
        ("port f32 production(3, 8, 6)", lambda: port_run(TConfig.production(3, 8, 6))),
        *((f"port bf16 (both), {n} torch threads",
           functools.partial(threaded, n, port_run, bf16_production(TConfig)))
          for n in (1, 2, 4)),
    ):
        devs = [float(np.max(np.abs(a - b))) for a, b in zip(got(), converged)]
        print(f"{label}: max |dev| u {devs[0]:.4e}, v {devs[1]:.4e}, p {devs[2]:.4e}; "
              f"max {max(devs):.4e} U_lid", flush=True)


def threaded(n, fn, *args):
    """fn(*args) with n torch threads: another order of the float32 sums."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(old)


def cavity256(nsteps=22):
    ref = j_cavity(N=256, Re=100.0, dt=0.01, max_steps=100, dtype=jnp.float32)
    ref.impl.cfg = bf16_production(JConfig)
    port = t_cavity(N=256, Re=100.0, dt=0.01, device="cpu", dtype=F32)
    port.impl.cfg = bf16_production(TConfig)
    print("step: |u|max reference, port; ksp_rnorm reference, port", flush=True)
    for k in range(nsteps):
        with jax.disable_jit():
            ref.step()
        port.step()
        print(f"{k + 1}: {float(jnp.max(jnp.abs(ref.state['v'][0]))):.4f}, "
              f"{float(port.state['v'][0].abs().max()):.4f}; "
              f"{float(ref.last_diag['ksp_rnorm']):.4g}, "
              f"{float(port.last_diag['ksp_rnorm']):.4g}", flush=True)


if __name__ == "__main__":
    {"pin": pin, "cavity256": cavity256}[sys.argv[1]]()
