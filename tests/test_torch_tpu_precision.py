"""Why fluca_tpu's production() collapsed on its TPU at 128^3 CFL 5.8 and
the port's does not on the card (TOLERANCE.json row
production_o3m8s6_128_cfl5.8: effective rtol 3.39e-2 at its first
recorded step, the second of the run, then 5.2e-2 to 0.98 and retention
0.0011; the card 2.59e-2 and 0.98).

The hypothesis: fluca_tpu leaves two float32 products at XLA's DEFAULT
precision, which on a TPU is one bf16 pass (operands rounded to bf16,
products summed in float32): the Krylov inner products (jnp.vdot in
fluca_tpu/solvers/krylov.py tree_dot) and the coarse pseudo-inverse
product of the multigrid (jnp.matmul in fluca_tpu/solvers/mg.py
_vcycle). The port computes both in full float32. A tolerance-driven
outer loop absorbs such error; a fixed budget keeps it.

The tests run the channel at a reduced grid with the 128^3 run's
convective CFL (dt scaled with the cell width: 2e-3 * 128 / N) and
stretch 2.0, in float32: fluca_tpu takes the first production() step
(the tolerance script's untimed one), and from the state it reaches both
packages take the second, the step whose effective rtol the record
starts with:

- fluca_tpu's step (its XLA path on the CPU, where DEFAULT precision is
  full float32) and the port's agree within the port's own one-rounding
  spread: the step is far from converged (effective rtol ~2e-2), so
  flipping the last bit of half of the u cells of the state moves the
  step's u by ~1e-3 and its effective rtol by up to ~30 %; the two
  packages part by less than twice that, in u (norm-scaled) and in the
  effective rtol;
- the port's step with the operands of those two products rounded to
  bf16 (patched in here, nothing in the package changes) reads a higher
  effective rtol than in float32 from the same one-rounding starts: in
  the mean, at the worst start and from most starts. That is the
  direction of the TPU's parting (3.39e-2 against 2.59e-2, 1.31x);
- op by op, in float64: the first operation where the two packages part
  is the momentum solve, by rounding that its fixed-budget BiCGStab
  amplifies ~30-100x per iteration at this CFL without converging. That
  amplifier is why the step's quality follows its products' rounding,
  and why a TPU's bf16-pass products move it. Inside the solve the
  rounding that parts first is that of the Krylov inner products:
  fluca_tpu's float64 jnp.vdot on the CPU sums less accurately than
  torch.dot, and with fluca_tpu's tree_dot swapped in the
  port's eight-iteration solve comes 17.5x (16^3) to 395x (128^3)
  closer to fluca_tpu's.

Run as a script for the readings at another grid and over more steps
(``PYTHONPATH=. python tests/test_torch_tpu_precision.py GRID STARTS
STEPS``; PERF.md's 128^3 numbers: ``128 4 5`` and ``128 16 1``), or for
the float64 momentum-solve gaps and inner-product errors at a grid
(``... test_torch_tpu_precision.py gaps GRID``).
"""

import statistics
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.models.channel import setup_channel_3d as j_channel3d
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu.solvers.krylov import tree_dot as j_tree_dot
from fluca_tpu_torch.interop import state_from_numpy
from fluca_tpu_torch.models.channel import setup_channel_3d as t_channel3d
from fluca_tpu_torch.ns import cnlinear as t_cnlinear
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig
from fluca_tpu_torch.solvers import mg as t_mg
from fluca_tpu_torch.solvers.krylov import tree_leaves

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

F32 = torch.float32
N = 16
SEEDS = tuple(range(1, 17))  # the one-rounding starts
# how far the two packages may part, as a multiple of the port's own
# one-rounding spread (the largest distance of a perturbed start's step
# from the unperturbed one)
SPREAD_FACTOR = 2.0
# the least rise of the mean effective rtol under bf16-rounded products
# (measured 1.22-1.33x over five sets of 8 starts at N 16, one thread; the
# TPU against the card at 128^3: 3.39e-2 / 2.59e-2 = 1.31x), and the
# least share of the starts whose rtol it raises (measured 7 or 8 of 8)
MEAN_RISE = 1.15
RAISED_SHARE = 0.75
# how much closer the port's momentum solve comes to fluca_tpu's with
# fluca_tpu's inner products swapped in (measured 5.2x and 17.5x at N 16)
DOT_SWAP_CLOSER = 3.0


def dt_of(n):
    """dt at the 128^3 run's convective CFL (5.8: dt 2e-3, h_x 4/128)."""
    return 2e-3 * 128 / n


def eff_rtol(diag) -> float:
    return float(diag["ksp_rnorm"]) / float(diag["rhs_norm"])


def bf16_pass_dot(a, b):
    """tree_dot with the float32 leaves' operands rounded to bf16 and the
    products summed in float32: a TPU's DEFAULT-precision jnp.vdot."""
    tot = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.dtype.itemsize < 4:
            d = torch.sum((x * y).to(F32))
        else:
            d = torch.dot(x.reshape(-1).bfloat16().to(F32), y.reshape(-1).bfloat16().to(F32))
        tot = d if tot is None else tot + d
    return tot


def bf16_pass_coarse_solve(self, lvl, b):
    """The coarse solve with the pseudo-inverse and the residual rounded
    to bf16 and the product summed in float32: a TPU's DEFAULT-precision
    jnp.matmul (the port's hierarchies here are float32 and whole)."""
    x = torch.matmul(self._coarse_pinv_acc.bfloat16().to(F32),
                     b.reshape(-1).bfloat16().to(F32))
    return x.to(b.dtype).reshape(lvl.mesh.cell_shape)


def j_run(n, steps):
    """fluca_tpu in float32: its first production() step, then ``steps``
    more: (the state after the first as numpy, with its step and time;
    effective rtol of each later step; u after the second)."""
    ns = j_channel3d(N=(n, n, n), dt=dt_of(n), max_steps=10**9, stretch_y=2.0,
                     dtype=jnp.float32)
    cfg = JConfig.production()
    cfg.diag_rhs_norm = True
    ns.impl.cfg = cfg
    ns.step()
    start = ({k: (tuple(np.asarray(x) for x in ns.state[k]) if k in ("v", "U")
                  else np.asarray(ns.state[k])) for k in ("v", "U", "p", "phalf")},
             ns.step_index, float(ns.t))
    rtols = []
    for k in range(steps):
        ns.step()
        rtols.append(eff_rtol(ns.last_diag))
        if k == 0:
            u = np.asarray(ns.state["v"][0], np.float64)
    return start, rtols, u


def t_run(n, start, steps, seed=0, bf16_products=False):
    """The port in float32 from fluca_tpu's state ``start``, its u moved by
    one unit in the last place at half of the cells (a seeded choice)
    unless ``seed`` is 0, for ``steps`` production() steps; with
    ``bf16_products`` the two products rounded as a TPU's DEFAULT precision
    rounds them: (effective rtol of each step, u after the first)."""
    with pytest.MonkeyPatch.context() as mp:
        if bf16_products:
            mp.setattr(t_cnlinear, "tree_dot", bf16_pass_dot)
            mp.setattr(t_mg.PoissonMG, "_coarse_solve", bf16_pass_coarse_solve)
        ns = t_channel3d(N=(n, n, n), dt=dt_of(n), max_steps=10**9, stretch_y=2.0, dtype=F32,
                         device="cpu")
        cfg = TConfig.production()
        cfg.diag_rhs_norm = True
        ns.impl.cfg = cfg
        state, ns.step_index, ns.t = start
        ns.state = state_from_numpy(state, "cpu", F32)
        if seed:
            u = ns.state["v"][0]
            flip = torch.rand(u.shape, generator=torch.Generator().manual_seed(seed)) < 0.5
            up = torch.nextafter(u, torch.full_like(u, float("inf")))
            ns.state["v"] = (torch.where(flip, up, u), *ns.state["v"][1:])
        rtols = []
        for k in range(steps):
            ns.step()
            rtols.append(eff_rtol(ns.last_diag))
            if k == 0:
                u = ns.state["v"][0].to(torch.float64).numpy()
    return rtols, u


def readings(n, seeds, steps=1):
    """Every run the tests read, at grid n: (effective rtol per step, u
    after the first step) of fluca_tpu, of the port, and of the port from
    each one-rounding start in float32 and with bf16-rounded products,
    all from fluca_tpu's state after its first step."""
    start, rtols, u = j_run(n, steps)
    return {"ref": (rtols, u), "port": t_run(n, start, steps),
            "f32": [t_run(n, start, steps, s) for s in seeds],
            "bf16": [t_run(n, start, steps, s, bf16_products=True) for s in seeds]}


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def runs():
    """The recorded step's (effective rtol, u) of every run."""
    return {k: (v[0][0], v[1]) if k in ("ref", "port") else [(r[0], u) for r, u in v]
            for k, v in readings(N, SEEDS).items()}


def test_bf16_pass_products_round_their_operands():
    """The patched products equal a float64 sum of the bf16-rounded
    operands' products to float32 rounding, and part from the float32
    products."""
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn(4096, generator=g) for _ in range(2))
    want = float((a.bfloat16().double() * b.bfloat16().double()).sum())
    got = float(bf16_pass_dot((a,), (b,)))
    assert abs(got - want) <= 1e-5 * float((a.abs() * b.abs()).sum())
    assert got != float(torch.dot(a, b))


def test_port_f32_step_agrees_with_fluca_tpu_f32_within_one_rounding(runs):
    r0, u0 = runs["port"]
    rj, uj = runs["ref"]
    spread_u = max(rel(u, u0) for _, u in runs["f32"])
    spread_r = max(abs(r - r0) for r, _ in runs["f32"])
    assert 0 < spread_u and 0 < spread_r
    assert rel(uj, u0) <= SPREAD_FACTOR * spread_u, (rel(uj, u0), spread_u)
    assert abs(rj - r0) <= SPREAD_FACTOR * spread_r, (rj, r0, spread_r)


def test_bf16_pass_products_raise_the_recorded_step_rtol(runs):
    f32 = [r for r, _ in runs["f32"]]
    bf16 = [r for r, _ in runs["bf16"]]
    assert all(np.isfinite(bf16))
    assert statistics.mean(bf16) >= MEAN_RISE * statistics.mean(f32), (f32, bf16)
    assert max(bf16) > max(f32), (f32, bf16)
    assert sum(b > f for b, f in zip(bf16, f32)) >= RAISED_SHARE * len(SEEDS), (f32, bf16)


# ----------------------------------------------------------------------
# where the two packages part: the momentum solve at CFL 5.8
# ----------------------------------------------------------------------

def momentum_solve_gaps(n, iters):
    """The first momentum solve of the port's first float64 production()
    step of the channel at grid n (CFL 5.8), replayed with ``iters``
    BiCGStab iterations on the same inputs in both packages: for each,
    (||fluca_tpu - port|| / ||port||, the largest distance of the port's
    solve when its rhs moves by one unit in the last place at half of the
    cells, the relative residual, and the distance from fluca_tpu's of the
    port's solve with fluca_tpu's tree_dot in place of its own)."""
    ns = t_channel3d(N=(n, n, n), dt=dt_of(n), max_steps=10**9, stretch_y=2.0,
                     dtype=torch.float64, device="cpu")
    ns.impl.cfg = TConfig.production()
    impl, ops = ns.impl, ns.impl.ops
    U0 = ns.state["U"]
    Bv0, bcB = ops.apply_B(ns.state["v"]), ops.bc_B(ns.t)
    v0f = tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(3)) for d in range(3))
    calls = []
    solve = impl._solve_momentum

    def record(rhs, Ac, dA):
        calls.append(tuple(x.clone() for x in rhs))
        return solve(rhs, Ac, dA)

    impl._solve_momentum = record
    ns.step()
    del impl._solve_momentum
    rhs = calls[0]
    ref = j_channel3d(N=(n, n, n), dt=dt_of(n), max_steps=10**9, stretch_y=2.0,
                      dtype=jnp.float64).impl
    ref.cfg = JConfig.production()
    Ac, dA = ops.build_momentum_operator(U0, v0f), ops.diag_A(U0, v0f)

    def j(xs):
        return tuple(jnp.asarray(x.numpy()) for x in xs)

    jU0, jv0f = j(U0), tuple(j(r) for r in v0f)
    jAc, jdA = ref.ops.build_momentum_coeffs(jU0, jv0f), ref.ops.diag_A(jU0, jv0f)

    def stack(xs):
        return np.stack([np.asarray(x, np.float64) for x in xs])

    def flipped(x, seed):
        flip = torch.rand(x.shape, generator=torch.Generator().manual_seed(seed)) < 0.5
        return torch.where(flip, torch.nextafter(x, torch.full_like(x, float("inf"))), x)

    def ref_dot(a, b):
        return torch.tensor(float(j_tree_dot(j(a), j(b))), dtype=torch.float64)

    out = []
    for it in iters:
        impl.cfg.mom_maxiter = ref.cfg.mom_maxiter = it
        port = impl._solve_momentum(rhs, Ac, dA)
        spread = max(rel(stack(impl._solve_momentum(tuple(flipped(x, s) for x in rhs), Ac, dA)),
                         stack(port)) for s in (1, 2))
        res = [r - a for r, a in zip(rhs, ops.apply_A_coeffs(port, Ac))]
        want = stack(ref._solve_momentum(j(rhs), jAc, jdA))
        own_dot, impl._dot = impl._dot, ref_dot
        swapped = impl._solve_momentum(rhs, Ac, dA)
        impl._dot = own_dot
        out.append((rel(want, stack(port)), spread,
                    float(np.linalg.norm(stack(res)) / np.linalg.norm(stack(rhs))),
                    rel(want, stack(swapped))))
    return out


@pytest.fixture(scope="module")
def gaps():
    """momentum_solve_gaps after one and after eight iterations."""
    return momentum_solve_gaps(N, (1, 8))


def test_packages_part_only_by_rounding_the_momentum_solve_amplifies(gaps):
    """The first operation where fluca_tpu's and the port's float64 steps
    part at CFL 5.8 is the momentum solve (the Schur solves agree at
    ~1e-15), and it parts by rounding only: after one BiCGStab iteration
    the two lie a few units of roundoff apart (measured 1.2e-15 at N 16);
    each iteration then amplifies any difference ~30-100x without
    converging (relative residual 0.52 -> 0.063 in 8), so after 8 the two
    are 7.2e-4 apart, ~10x the distance a one-unit move of the rhs gives
    the port's own solve (7.2e-5), the same ratio as after one iteration.
    A different algorithm parts at O(1e-2) or more at the first iteration.
    The TPU's bf16-pass products inject ~4e-3 relative error into each
    BiCGStab coefficient: amplified so, they decide the solve."""
    (gap1, spread1, _, _), (gap8, spread8, res8, _) = gaps
    assert gap1 <= 1e-13, gap1
    assert 1e-7 <= spread8 and res8 > 1e-2, (spread8, res8)
    assert gap8 <= 30 * spread8 and gap8 / spread8 <= 3 * max(gap1 / spread1, 1.0), \
        (gap1, spread1, gap8, spread8)


def test_the_solves_part_first_at_fluca_tpus_inner_products(gaps):
    """With fluca_tpu's tree_dot in the port's BiCGStab, the port's solve
    comes at least DOT_SWAP_CLOSER times closer to fluca_tpu's after one
    iteration and after eight: the rounding that parts the two packages
    first is that of the Krylov inner products, not of the A-apply or the
    vector algebra (measured at N 16 with one thread: 5.2x and 17.5x; at
    128^3 with four threads 341x and 395x)."""
    (gap1, _, _, swap1), (gap8, _, _, swap8) = gaps
    assert swap1 * DOT_SWAP_CLOSER <= gap1, (gap1, swap1)
    assert swap8 * DOT_SWAP_CLOSER <= gap8, (gap8, swap8)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["gaps"]:
        # float64: momentum_solve_gaps after 1 and 8 iterations, and each
        # package's tree_dot of three random n^3 leaves with themselves
        # against an extended-precision sum (relative errors)
        jax.config.update("jax_enable_x64", True)
        n = int(sys.argv[2]) if len(sys.argv) > 2 else N
        g = np.random.default_rng(0)
        xs = [g.standard_normal(n ** 3) for _ in range(3)]
        exact = float(sum(np.dot(x.astype(np.longdouble), x.astype(np.longdouble)) for x in xs))
        jd = float(j_tree_dot([jnp.asarray(x) for x in xs], [jnp.asarray(x) for x in xs]))
        td = float(t_cnlinear.tree_dot(*[[torch.from_numpy(x) for x in xs]] * 2))
        print({"grid": n, "gaps": {it: dict(zip(("fluca_tpu_vs_port", "one_rounding_spread",
                                                 "rel_residual", "port_with_fluca_tpu_dot"), r))
                                   for it, r in zip((1, 8), momentum_solve_gaps(n, (1, 8)))},
               "dot_rel_err": {"fluca_tpu": (jd - exact) / exact, "port": (td - exact) / exact}},
              flush=True)
        sys.exit(0)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else N
    k = int(sys.argv[2]) if len(sys.argv) > 2 else len(SEEDS)
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    r = readings(n, range(1, k + 1), steps)
    u0 = r["port"][1]
    by_step = [{"step": s + 2,
                "fluca_tpu_f32": r["ref"][0][s], "port_f32": r["port"][0][s],
                "port_f32_starts": [x[s] for x, _ in r["f32"]],
                "port_bf16_products_starts": [x[s] for x, _ in r["bf16"]]}
               for s in range(steps)]
    for row in by_step:
        row["mean_f32"] = statistics.mean(row["port_f32_starts"])
        row["mean_bf16_products"] = statistics.mean(row["port_bf16_products_starts"])
    print({"grid": n, "dt": dt_of(n), "starts": k,
           "u_apart_fluca_tpu_vs_port": rel(r["ref"][1], u0),
           "u_one_rounding_spread": max(rel(u, u0) for _, u in r["f32"]),
           "by_step": by_step}, flush=True)
