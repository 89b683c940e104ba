"""CNLinear: linearized Crank-Nicolson NS time stepping (2-D and 3-D).

Counterpart of fluca_tpu.ns.cnlinear (reference NSCNLINEAR,
fluca/src/ns/impl/linearcn/cnlinear.c + cnlinearcart2d.c:1933-2171,
with the ABF preconditioner of fluca/src/ns/utils/abfpc/abfpc.c).

One time step solves the coupled 3x3 saddle system (THEORY_GUIDE
eq. 13)

    [ A   0   G  ] [ v  ]   [ momrhs    ]
    [ -T  I  -R  ] [ U  ] = [ interprhs ]
    [ 0   D   0  ] [ p' ]   [ 0         ]

with flexible GMRES to rtol 1e-5 on the unpreconditioned residual
(reference nssol.c:22-25), or a fixed-budget GCR, preconditioned by the
(LD)U approximate block factorization:

    v* = kspA^-1 momrhs            (BiCGStab + Jacobi)
    U* = interprhs + T v*
    p  = kspS^-1 (contrhs - D U*)  (CG + geometric multigrid on -D Gst)
    v  = v* - G p,   U = U* - Gst p     (abfpc.c:48-111)

then updates the pressure by extrapolation (cnlinearcart2d.c:1969-1980):
    step 0: p <- p0 + 2 dp,     phalf <- p0 + dp
    else  : p <- phalf + 1.5 dp, phalf <- phalf + dp

The step runs eagerly on the solver's device. The fixed-budget presets
(``production``, ``production_fast``) read nothing back to the host
inside a step; the caller's converged check is the one synchronisation.

``precond_dtype="bfloat16"`` runs the ABF preconditioner's inner solves
(momentum, and with ``precond_scope="both"`` the Schur multigrid) in
bf16 through the kernels' bf16 instances; the outer Krylov iteration,
the T/D/G/Gst chains, the coupled residual and the state stay in the
solver dtype (reference cnlinear.py:108-128, 566-724).

The three stages around the momentum solve (the coupled apply's
G/T/R/D epilogue, and the ABF pre and post stages) run through
``_stages``, picked from the mesh: in 3-D the fused chain kernel
(``ops/chain3d.py`` ``Chain3D``), in 2-D and under a device grid of more
than one shard (``set_device_grid``) the banded operators
(``UnfusedChain``). The ABF stages take the chain with ``schur_ainv``
and ``upper_ainv`` both "id", as the reference's ``ops._chain3d``
branch does (cnlinear.py:726-736), and in the reduced-precision ``pre``
branch too, whose stages take and return the solver dtype. There the
port departs from fluca_tpu, whose ``pre`` branch keeps the banded
chains even with its chain kernel on (cnlinear.py:697-722).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.operators import NSOperators
from fluca_tpu_torch.ops.chain3d import Chain3D
from fluca_tpu_torch.solvers.krylov import (
    KrylovResult, bicgstab, cg, fgmres, gcr, tree_add, tree_dot, tree_sub,
)
from fluca_tpu_torch.solvers.mg import PoissonMG
from fluca_tpu_torch.utils import config, profiling
from fluca_tpu_torch.utils.profiling import span

# a tolerance at or below this is a fixed budget: the solver never
# stops early, so it runs without host reads
_FIXED_BUDGET_RTOL = 1e-20


@dataclass
class CNLinearConfig:
    rtol: float = 1e-5          # outer coupled FGMRES (nssol.c:22-25)
    restart: int = 30
    maxiter: int = 200
    mom_rtol: float = 1e-5      # kspA (abf_momentum_)
    mom_maxiter: int = 100
    schur_rtol: float = 1e-5    # kspS (abf_schur_)
    schur_maxiter: int = 200
    mg_levels: bool = True
    # Atilde approximations in the ABF factorization
    # (-pc_abf_schur_ainv_type / -pc_abf_upper_ainv_type,
    # abfpc.c:240-252); 'id' is the fractional-step limit
    schur_ainv: str = "id"      # id | diag | rowsum
    upper_ainv: str = "id"
    # warm-start the coupled solve from the old velocity state
    # (reference uses a zero initial guess, nsbasic.c:247-251; this
    # changes only the iteration count, not the converged solution).
    # Only the tolerance (FGMRES) outer takes it.
    warm_start: bool = False
    # "coupled": iterate the outer solver on the full saddle system.
    # "fsm": one ABF pass with Atilde = I, the classical
    # fractional-step method (O(dt) splitting error with this
    # operator; kept for parity)
    solve_type: str = "coupled"  # coupled | fsm
    # fixed-budget mode (PETSc KSPConvergedSkip analogue): run the
    # outer iteration to maxiter and accept the result if finite
    converged_skip: bool = False
    # outer_type   "fgmres" | "gcr" | "richardson" (the last needs
    #              converged_skip)
    # mom_solver   "bicgstab" | "jacobi" (mom_maxiter damped sweeps)
    #              | "gcr" (fixed-budget Jacobi-preconditioned GCR)
    # schur_solver "cg" | "vcycle" (schur_maxiter MG-Richardson
    #              iterations)
    outer_type: str = "fgmres"
    mom_solver: str = "bicgstab"
    schur_solver: str = "cg"
    mom_omega: float = 1.0
    # run the ABF preconditioner's inner solves in reduced precision
    # ("bfloat16", or "float32" under a float64 solve). The outer
    # iteration is flexible, so an inexact M changes the contraction
    # rate, not the converged answer. Fixed-budget configs only. None:
    # the inner solves run in the solver dtype.
    precond_dtype: str | None = None
    # which inner solves run in precond_dtype: "both", or "mom" (the
    # Schur solve stays in the solver dtype)
    precond_scope: str = "both"
    # report ||rhs|| in the step diagnostics so an achieved relative
    # tolerance (reference semantics: KSP rtol on the unpreconditioned
    # norm, nssol.c:24-25) can be formed as ksp_rnorm / rhs_norm.
    # Off by default: it adds one full-tree reduction per step.
    diag_rhs_norm: bool = False

    @classmethod
    def production(cls, outer=3, mom=8, schur=6):
        """Fixed-budget preset: GCR outer + BiCGStab momentum + CG
        Schur with fixed iteration counts and no tolerance checks
        (reproduces the rtol-1e-5 TGV accuracy in the reference's
        tests)."""
        return cls(
            rtol=1e-30, maxiter=outer, restart=outer,
            converged_skip=True,
            mom_rtol=1e-30, mom_maxiter=mom,
            schur_rtol=1e-30, schur_maxiter=schur,
            outer_type="gcr",
        )

    @classmethod
    def production_fast(cls, outer=3, mom=8, schur=6, mom_omega=1.0,
                        outer_type="gcr"):
        """Fixed-budget preset: GCR outer + damped-Jacobi momentum +
        MG-Richardson Schur (no inner Krylov bookkeeping). The outer
        stays GCR because plain Richardson diverges once the convective
        CFL passes ~1."""
        return cls(
            rtol=1e-30, maxiter=outer, restart=outer,
            converged_skip=True,
            mom_rtol=1e-30, mom_maxiter=mom,
            schur_rtol=1e-30, schur_maxiter=schur,
            outer_type=outer_type, mom_solver="jacobi",
            schur_solver="vcycle", mom_omega=mom_omega,
        )

    @classmethod
    def from_options(cls, opts, prefix="ns_"):
        o = opts.sub(prefix)
        return cls(
            rtol=o.get_real("ksp_rtol", 1e-5),
            restart=o.get_int("ksp_gmres_restart", 30),
            maxiter=o.get_int("ksp_max_it", 200),
            mom_rtol=o.get_real("abf_momentum_ksp_rtol", 1e-5),
            mom_maxiter=o.get_int("abf_momentum_ksp_max_it", 100),
            schur_rtol=o.get_real("abf_schur_ksp_rtol", 1e-5),
            schur_maxiter=o.get_int("abf_schur_ksp_max_it", 200),
            schur_ainv=o.get_str("pc_abf_schur_ainv_type", "id"),
            upper_ainv=o.get_str("pc_abf_upper_ainv_type", "id"),
            solve_type=o.get_str("solve_type", "coupled"),
            outer_type=o.get_str("ksp_type", "fgmres"),
            mom_solver=o.get_str("abf_momentum_ksp_type", "bicgstab"),
            schur_solver=o.get_str("abf_schur_ksp_type", "cg"),
            converged_skip=o.get_bool("ksp_convergence_test_skip", False),
        )


class UnfusedChain:
    """The chain stages on the banded operators of ``ops``, one sweep
    per operator: the stages of the 2-D step, of a device grid of more
    than one shard or a rank-held grid, and of the ``diag``/``rowsum``
    ainv variants, and the A/B witness of the fused chain. Same methods
    as ``Chain3D``.

    In 3-D on one device the reduced-precision ``pre`` branch runs the
    fused chain, where fluca_tpu's keeps these banded stages even with
    its chain kernel on (fluca_tpu/ns/cnlinear.py:697-722): its stages
    see solver-dtype tensors either way."""

    def __init__(self, ops: NSOperators):
        self.ops = ops

    def coupled(self, Av, v, U, p):
        """(Av + G p, U - T v - R p, D U)."""
        ops = self.ops
        Gp = ops.apply_G(p)
        Tv = ops.apply_T(v)
        Rp = ops.apply_R(p)
        return (tuple(Av[c] + Gp[c] for c in range(ops.dim)),
                tuple(U[d] - Tv[d] - Rp[d] for d in range(ops.dim)),
                ops.apply_D(U))

    def abf_pre(self, v, rU, rp):
        """(U*, rp - D U*) with U* = rU + T v."""
        Tv = self.ops.apply_T(v)
        Ustar = tuple(rU[d] + Tv[d] for d in range(self.ops.dim))
        return Ustar, rp - self.ops.apply_D(Ustar)

    def abf_post(self, vstar, Ustar, p):
        """(v* - G p, U* - Gst p): with Atilde2 = I, -T G p + R p = -Gst p
        exactly (R = T G - Gst), so the U back-substitution is one
        operator."""
        Gp = self.ops.apply_G(p)
        Gstp = self.ops.apply_Gst(p)
        return (tuple(vstar[c] - Gp[c] for c in range(self.ops.dim)),
                tuple(Ustar[d] - Gstp[d] for d in range(self.ops.dim)))


class CNLinearSolver:
    def __init__(
        self,
        mesh: CartMesh,
        bcs,
        rho: float,
        mu: float,
        dt: float,
        cfg: CNLinearConfig | None = None,
        dtype=None,
        device="cuda",
        grid=None,
    ):
        from fluca_tpu_torch.parallel.mesh import RankGrid, same_device

        self.dtype = config.resolve_dtype(dtype)
        self.device = torch.device(device)
        self.cfg = cfg or CNLinearConfig()
        if grid is not None and not same_device(grid.device, self.device):
            raise ValueError(f"device grid on {grid.device}, solver on {self.device}")
        # a rank-held grid: the operators and the hierarchy are built on
        # this rank's block from the start
        held = grid if isinstance(grid, RankGrid) else None
        self.ops = NSOperators(mesh, bcs, rho, mu, dt, self.dtype, self.device,
                               grid=held)
        # the chain stages: the fused kernel in 3-D, the banded operators
        # in 2-D (and for the branches the chain does not serve, and
        # under a device grid)
        self._unfused = UnfusedChain(self.ops)
        self._chain = None
        if mesh.dim == 3 and held is None:
            self._chain = Chain3D(mesh, self.ops.axbcs, rho, dt, self.dtype,
                                  self.device)
        self._stages = self._unfused if self._chain is None else self._chain
        self.mesh = mesh
        self.dt = float(dt)
        self.rho = float(rho)
        self.mu = float(mu)
        # multigrid hierarchy for Shat = vol .* (-D Gst)
        self.mg = PoissonMG(mesh, bcs, scale=dt / rho, dtype=self.dtype,
                            device=self.device, grid=held)
        self.pin_pressure = not self.ops.has_pressure_outlet
        # the precond_dtype multigrid twin, built on first use
        # (_pre_resources)
        self._pre16 = None
        # the device grid (set_device_grid; None = one shard)
        self.grid = None
        # the tree inner product of every Krylov solve (a rank-held grid
        # adds the blocks' sums over the ranks)
        self._dot = tree_dot if held is None else self._rank_dot
        # optional momentum body-force hook: f(state0, t) -> cell
        # vector; added to the momentum RHS as dt * f (the channel's
        # mean-pressure-gradient forcing)
        self.body_force = None
        if grid is not None:
            self.set_device_grid(grid)

    # -- domain decomposition -------------------------------------------
    def set_device_grid(self, grid) -> None:
        """Run the step sharded over ``grid``
        (fluca_tpu/ns/cnlinear.py:249-337, the reference's rank
        decomposition, cart.c:85-151): the momentum A-apply through its
        sharded form (parallel/sharded.py) and each multigrid level the
        grid splits evenly through the sharded Poisson kernel.

        On a ``DeviceGrid`` the shards are boxes of the global tensors on
        the solver's one device (``parallel/mesh.py``), so the banded
        operators and the Krylov algebra run on the global tensors as they
        are (``PoissonMG.set_device_grid``).

        A ``RankGrid`` is given to the constructor (``grid=``), never
        here: this rank then holds its block of every field from the
        start, the operators and the hierarchy are built on the block
        (``NSOperators(grid=)``, ``PoissonMG(grid=)``), the banded
        operators read past it through rank-to-rank exchanges, and every
        dot, norm and mean sums over the block and adds the sums over the
        ranks (``_dot``, ``_sum``). Such a solver keeps its grid.

        As in the reference, a grid of more than one shard runs the
        unfused chain (``UnfusedChain``: the reference runs its chain
        kernel on one device only, fluca_tpu/ns/cnlinear.py:297-301) and
        turns the reduced-precision preconditioner off
        (``_pre_resources``). ``grid=None``, or a degenerate grid of one
        shard, restores the single-device kernels; the latter is recorded
        as the grid all the same."""
        from fluca_tpu_torch.parallel.mesh import RankGrid, same_device
        from fluca_tpu_torch.parallel.sharded import (
            build_momentum2d_sharded, build_momentum_sharded,
        )

        if grid is not None and not same_device(grid.device, self.device):
            raise ValueError(f"device grid on {grid.device}, solver on {self.device}")
        held = isinstance(grid, RankGrid)
        if held != self.rank_held or (held and grid is not self.ops.grid):
            raise ValueError("a rank-held grid is given when the solver is built "
                             "(CNLinearSolver(grid=), NS(grid=)), and the solver keeps it")
        self.grid = grid
        self._pre16 = None
        ops = self.ops
        if grid is None or grid.size == 1:
            ops.sharded_momentum = None
            self._stages = self._unfused if self._chain is None else self._chain
            self.mg.set_device_grid(None)
            return
        if self.mesh.dim == 2:
            ops.sharded_momentum = build_momentum2d_sharded(grid, self.mesh, self.dtype)
        else:
            ops.sharded_momentum = build_momentum_sharded(
                grid, self.mesh, ops.axbcs, self.rho, self.mu, self.dt, self.dtype)
        self._stages = self._unfused
        if not held:
            self.mg.set_device_grid(grid)

    @property
    def sharded(self) -> bool:
        """Whether a grid of more than one shard is set."""
        return self.grid is not None and self.grid.size > 1

    @property
    def rank_held(self) -> bool:
        """Whether this process holds one block of a rank-held grid."""
        return self.ops.grid is not None

    def _rank_dot(self, a, b):
        """``tree_dot`` over this rank's blocks, added over the ranks (with
        faces owned lo + hilast, each face counts once)."""
        return self.grid.allsum(tree_dot(a, b))

    def _sum(self, x):
        """The sum of the field ``x`` (added over the ranks under a
        rank-held grid)."""
        s = torch.sum(x)
        return self.grid.allsum(s) if self.rank_held else s

    def _norm(self, tree):
        return torch.sqrt(self._dot(tree, tree))

    # -- state ---------------------------------------------------------
    def zero_state(self) -> dict:
        """The zero state on the operators' block (the whole grid, or this
        rank's block of a rank-held grid)."""
        blk = self.ops.block

        def zeros(shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return {
            "v": tuple(zeros(blk.cell_shape) for _ in range(blk.dim)),
            "U": tuple(zeros(blk.face_shape(d)) for d in range(blk.dim)),
            "p": zeros(blk.cell_shape),
            "phalf": zeros(blk.cell_shape),
        }

    def _budget_rtol(self, rtol):
        """None (a fixed budget, no host reads) where the config skips
        convergence tests and the tolerance can never be met."""
        if self.cfg.converged_skip and rtol <= _FIXED_BUDGET_RTOL:
            return None
        return rtol

    # -- coupled operator & preconditioner ----------------------------
    def _coupled_apply(self, x, Acoeffs):
        v, U, p = x["v"], x["U"], x["p"]
        Av = self.ops.apply_A_coeffs(v, Acoeffs)
        out_v, out_U, out_p = self._stages.coupled(Av, v, U, p)
        return {"v": out_v, "U": out_U, "p": out_p}

    def _pressure_mean(self, p, mg=None):
        """Volume-weighted mean of p with the volumes of ``mg`` (the
        solver's hierarchy if None): the product rounded in the
        hierarchy's dtype, the sums in at least float32 (the
        reference's rule for reduced-precision fields,
        cnlinear.py:487-494)."""
        vol = (mg or self.mg).levels[0].vol
        acc = torch.promote_types(p.dtype, torch.float32)
        num, den = torch.sum((vol * p).to(acc)), torch.sum(vol.to(acc))
        if self.rank_held:
            num, den = self.grid.allsum(torch.stack([num, den]))
        return (num / den).to(p.dtype)

    def _project_p(self, p, mg=None):
        """Remove the constant-pressure nullspace component (reference
        attaches a constant nullspace to S, abfpc.c:170-179), weighted
        by the volumes of ``mg`` (the solver's hierarchy if None)."""
        if not self.pin_pressure:
            return p
        return p - self._pressure_mean(p, mg)

    def _solve_momentum(self, rhs_v, Acoeffs, diagA):
        ops = self.ops
        cfg = self.cfg
        inv_diag = tuple(1.0 / d for d in diagA)

        def A(v):
            return ops.apply_A_coeffs(v, Acoeffs)

        def M(r):
            return tuple(inv_diag[c] * r[c] for c in range(ops.dim))

        if cfg.mom_solver == "gcr":
            profiling.count("iters.momentum", cfg.mom_maxiter)
            return gcr(A, rhs_v, maxiter=cfg.mom_maxiter, M=M, dot=self._dot).x
        if cfg.mom_solver == "jacobi":
            profiling.count("iters.momentum", cfg.mom_maxiter)
            # mom_maxiter damped-Jacobi sweeps: one fused A-apply and
            # an elementwise update per sweep, no reductions
            w = cfg.mom_omega
            x = tuple(w * inv_diag[c] * rhs_v[c] for c in range(ops.dim))
            for _ in range(cfg.mom_maxiter - 1):
                Ax = A(x)
                x = tuple(
                    x[c] + w * inv_diag[c] * (rhs_v[c] - Ax[c])
                    for c in range(ops.dim)
                )
            return x
        if cfg.mom_solver != "bicgstab":
            raise ValueError(f"unknown momentum solver {cfg.mom_solver!r}")
        res = bicgstab(
            A, rhs_v, rtol=self._budget_rtol(cfg.mom_rtol),
            maxiter=cfg.mom_maxiter, M=M, dot=self._dot,
        )
        profiling.count("iters.momentum", res.iters)
        return res.x

    def _ainv_diag(self, kind: str, Acoeffs, diagA):
        """1/Atilde as a per-component diagonal field, or None for
        identity. 'diag' uses diag(A); 'rowsum' uses A @ 1 (the lumped
        row-sum), both matrix-free (abfpc.c Atilde options)."""
        if kind == "id":
            return None
        if kind == "diag":
            return tuple(1.0 / d for d in diagA)
        if kind == "rowsum":
            ones = tuple(
                torch.ones(self.ops.block.cell_shape, dtype=self.dtype,
                           device=self.device)
                for _ in range(self.ops.dim)
            )
            rs = self.ops.apply_A_coeffs(ones, Acoeffs)
            return tuple(
                1.0 / torch.where(r == 0, torch.ones_like(r), r) for r in rs
            )
        raise ValueError(f"unknown ainv type {kind!r}")

    def _solve_schur(self, rhs_p, ainv1=None, mg=None):
        """Solve Stilde p = rhs with CG+MG (Atilde1 = I, symmetric),
        MG-Richardson ('vcycle'), or FGMRES+MG (diag/rowsum,
        nonsymmetric Stilde = D T (I - Atilde1^-1) G - D Gst).

        ``mg`` replaces the solver's hierarchy (the precond_dtype twin);
        the constant-nullspace projection then uses its volumes."""
        mg = mg or self.mg
        proj = partial(self._project_p, mg=mg) if self.pin_pressure else None
        cfg = self.cfg
        if ainv1 is None and cfg.schur_solver == "vcycle":
            # schur_maxiter V-cycle Richardson iterations; the constant
            # mode is projected once at the end (G of a constant is 0)
            profiling.count("iters.schur", cfg.schur_maxiter)
            b = mg.scale_rhs(rhs_p)
            lvl0 = mg.levels[0]
            p = mg.precondition(b)
            for _ in range(cfg.schur_maxiter - 1):
                r = mg._residual(lvl0, p, b)
                p = p + mg.precondition(r)
            return proj(p) if proj else p
        if ainv1 is None:
            if cfg.schur_solver != "cg":
                raise ValueError(f"unknown Schur solver {cfg.schur_solver!r}")
            res = cg(
                mg.apply_op,
                mg.scale_rhs(rhs_p),
                rtol=self._budget_rtol(cfg.schur_rtol),
                maxiter=cfg.schur_maxiter,
                M=mg.precondition,
                project=proj,
                dot=self._dot,
            )
            profiling.count("iters.schur", res.iters)
            return res.x
        ops = self.ops

        def S(p):
            # Stilde p = D T (I - Atilde1^-1) G p - D Gst p, vol-scaled
            # to match the MG preconditioner
            Gp = ops.apply_G(p)
            corr = tuple(Gp[c] - ainv1[c] * Gp[c] for c in range(ops.dim))
            out = ops.apply_D(ops.apply_T(corr)) - ops.apply_DGst(p)
            return mg.scale_rhs(out)

        res = fgmres(
            S, mg.scale_rhs(rhs_p), rtol=cfg.schur_rtol,
            maxiter=cfg.schur_maxiter, restart=30, M=mg.precondition,
            dot=self._dot,
        )
        profiling.count("iters.schur", res.iters)
        p = res.x
        return proj(p) if proj else p

    # -- reduced-precision preconditioner ------------------------------
    def _pre_resources(self):
        """The precond_dtype resources, built once: its dtype and, for
        scope "both", a PoissonMG hierarchy in that dtype (None for
        "mom"). None when precond_dtype is off, or under a device grid of
        more than one shard (the reference's rule: its sharded kernels
        have no reduced-precision instance, cnlinear.py:570-576). Raises for
        tolerance-based inner solves, which the reduced-precision path
        does not run (reference cnlinear.py:566-635)."""
        cfg = self.cfg
        if cfg.precond_dtype is None or self.sharded:
            return None
        if cfg.precond_scope not in ("both", "mom"):
            raise ValueError(f"unknown precond_scope {cfg.precond_scope!r}")
        if not (
            cfg.converged_skip
            and cfg.mom_rtol <= _FIXED_BUDGET_RTOL
            and (cfg.precond_scope == "mom"
                 or cfg.schur_rtol <= _FIXED_BUDGET_RTOL)
        ):
            raise ValueError(
                "precond_dtype requires a fixed-budget config "
                "(converged_skip=True with inner rtols <= 1e-20, e.g. "
                "CNLinearConfig.production()); tolerance-based inner "
                "solves cannot run in reduced precision"
            )
        pdt = config.resolve_dtype(cfg.precond_dtype)
        want_mg = cfg.precond_scope == "both"
        pre = self._pre16
        if pre is None or pre["dtype"] != pdt \
                or (pre["mg"] is not None) != want_mg:
            pre = {"dtype": pdt, "mg": None}
            if want_mg:
                pre["mg"] = PoissonMG(
                    self.mesh, self.ops.bcs, scale=self.dt / self.rho,
                    dtype=pdt, device=self.device,
                )
            self._pre16 = pre
        return pre

    def _precond_ctx(self, Acoeffs, diagA, U0, v0f):
        """The step's reduced-precision context, or None: diag(A) cast
        once, and the A-apply's coefficients in that dtype: in 2-D the
        plane stack cast once, in 3-D the factors built from (U0, v0f)
        in that dtype, never the solver-dtype factors cast (reference
        cnlinear.py:637-683). ``apply_A_coeffs`` takes either as it
        is."""
        res = self._pre_resources()
        if res is None:
            return None
        pdt = res["dtype"]
        ops = self.ops
        if ops.dim == 2:
            Ac = Acoeffs.to(pdt)
        else:
            Ac = ops.build_momentum_factors_3d(U0, v0f, pdt)
        return {
            "dtype": pdt,
            "mg": res["mg"],
            "diagA": tuple(d.to(pdt) for d in diagA),
            "Acoeffs": Ac,
        }

    def _abf_apply(self, r, Acoeffs, diagA, pre=None):
        """PCApply_ABF (abfpc.c:48-111), its stages in the spans
        ``abf.momentum``, ``abf.pre``, ``abf.schur`` and ``abf.post``.

        ``pre`` (from _precond_ctx): the inner solves in reduced
        precision, for both ainv "id"; the chain stages and the result
        stay in the solver dtype (reference cnlinear.py:685-724)."""
        ops = self.ops
        ainv1 = self._ainv_diag(self.cfg.schur_ainv, Acoeffs, diagA)
        ainv2 = self._ainv_diag(self.cfg.upper_ainv, Acoeffs, diagA)
        chained = ainv1 is None and ainv2 is None
        stages = self._stages if chained else self._unfused
        pre = pre if chained else None
        with span("abf.momentum"):
            if pre is None:
                vstar = self._solve_momentum(r["v"], Acoeffs, diagA)
            else:
                vstar = self._solve_momentum(tuple(x.to(pre["dtype"]) for x in r["v"]),
                                             pre["Acoeffs"], pre["diagA"])
                vstar = tuple(x.to(self.dtype) for x in vstar)
        # U* = rU + T v*, and the rhs for Schur: contrhs - D U*
        with span("abf.pre"):
            Ustar, rp = stages.abf_pre(vstar, r["U"], r["p"])
        with span("abf.schur"):
            if pre is None or pre["mg"] is None:
                p = self._solve_schur(rp, ainv1=ainv1)
            else:
                p = self._solve_schur(rp.to(pre["dtype"]), mg=pre["mg"]).to(self.dtype)
        with span("abf.post"):
            if ainv2 is None:
                v, U = stages.abf_post(vstar, Ustar, p)
                return {"v": v, "U": U, "p": p}
            Gp = ops.apply_G(p)
            Gp2 = tuple(ainv2[c] * Gp[c] for c in range(ops.dim))
            # U update: U* - (T Atilde2^-1 G - R) p, with R = T G - Gst
            TGp2 = ops.apply_T(Gp2)
            Rp = ops.apply_R(p)
            v = tuple(vstar[c] - Gp2[c] for c in range(ops.dim))
            U = tuple(Ustar[d] - TGp2[d] + Rp[d] for d in range(ops.dim))
        return {"v": v, "U": U, "p": p}

    # -- RHS (FormFunction; cnlinearcart2d.c:2071-2171) ----------------
    def _form_rhs(self, sol0, phalf, t, is_first_step: bool):
        ops = self.ops
        dim = ops.dim
        dt, rho, mu = self.dt, self.rho, self.mu
        v0 = sol0["v"]
        s_visc = 0.5 * mu * dt / rho
        s_g = dt / rho

        if is_first_step:
            q, t_q = sol0["p"], t
        else:
            q, t_q = phalf, t - 0.5 * dt

        Gq = ops.apply_G(q)
        bcGq = ops.bc_G(t_q)
        Lv0 = ops.apply_L(v0)
        bcLt = ops.bc_L(t)
        bcLt1 = ops.bc_L(t + dt)
        bcC = ops.bc_C(t, t + dt)

        momrhs = tuple(
            v0[c]
            + s_visc * (Lv0[c] + bcLt[c])
            - dt * bcC[c]
            - (Gq[c] + s_g * bcGq[c])
            + s_visc * bcLt1[c]
            for c in range(dim)
        )

        # interp rhs: bcT(t+dt) + (-T)[(dt/rho)(bcG(tq)-bcG(t+dt/2))]
        #             + (dt/rho)(bcGst(tq)-bcGst(t+dt/2))
        bcT1 = ops.bc_T(t + dt)
        bcGp = ops.bc_G(t + 0.5 * dt)
        bcGstp = ops.bc_Gst(t + 0.5 * dt)
        bcGstq = ops.bc_Gst(t_q)
        dG = tuple(s_g * (bcGq[c] - bcGp[c]) for c in range(dim))
        TdG = ops.apply_T(dG)
        interprhs = tuple(
            bcT1[d] - TdG[d] + s_g * (bcGstq[d] - bcGstp[d])
            for d in range(dim)
        )

        contrhs = torch.zeros(self.ops.block.cell_shape, dtype=self.dtype,
                              device=self.device)
        return {"v": momrhs, "U": interprhs, "p": contrhs}

    # -- one time step -------------------------------------------------
    def _outer_solve(self, rhs, Acoeffs, diagA, pre=None, x0=None) -> KrylovResult:
        """The coupled solve; ``pre`` is the reduced-precision context,
        ``x0`` the FGMRES outer's initial guess (the fixed-budget outers
        start from zero). Each A runs in the span ``outer.apply``, each M
        in ``abf``; what is left of the caller's span is the outer
        solver's own algebra."""
        cfg = self.cfg

        def A(x):
            with span("outer.apply"):
                return self._coupled_apply(x, Acoeffs)

        def M(r):
            with span("abf"):
                return self._abf_apply(r, Acoeffs, diagA, pre)

        if cfg.solve_type == "fsm":
            # classical fractional step: one ABF application is the
            # solve; the coupled residual is reported for diagnostics
            x = M(rhs)
            rnorm = self._norm(tree_sub(rhs, A(x)))
            return KrylovResult(x=x, iters=1, rnorm=rnorm,
                                converged=torch.isfinite(rnorm))
        if cfg.solve_type != "coupled":
            raise ValueError(f"unknown solve type {cfg.solve_type!r}")
        if cfg.outer_type == "gcr":
            res = gcr(A, rhs, maxiter=cfg.maxiter, M=M, dot=self._dot)
            res.converged = torch.logical_and(
                res.converged, torch.isfinite(self._sum(res.x["p"]))
            )
            return res
        if cfg.outer_type == "richardson":
            if not cfg.converged_skip:
                raise ValueError(
                    "the richardson outer is fixed-budget: it needs "
                    "converged_skip (-ns_ksp_convergence_test_skip)"
                )
            # maxiter iterations of x += M(rhs - A x)
            x = M(rhs)
            rlast = rhs
            for _ in range(cfg.maxiter - 1):
                rlast = tree_sub(rhs, A(x))
                x = tree_add(x, M(rlast))
            # rnorm: the coupled residual before the last correction;
            # the final iterate is probed for NaN/inf too
            rnorm = self._norm(rlast)
            return KrylovResult(
                x=x, iters=cfg.maxiter, rnorm=rnorm,
                converged=torch.logical_and(
                    torch.isfinite(rnorm), torch.isfinite(self._sum(x["p"]))
                ),
            )
        if cfg.outer_type != "fgmres":
            raise ValueError(f"unknown outer solver {cfg.outer_type!r}")
        return fgmres(A, rhs, x0=x0, rtol=cfg.rtol, restart=cfg.restart,
                      maxiter=cfg.maxiter, M=M, dot=self._dot)

    def _step_impl(self, state, t, is_first_step: bool):
        """One step, in the spans ``step.rhs``, ``step.coeffs``,
        ``step.outer`` and ``step.project``."""
        ops = self.ops
        dim = ops.dim
        sol0 = state
        U0 = sol0["U"]

        with span("step.rhs"):
            # v0interp = B v0 + bcB(t)   (cnlinearcart2d.c:1947-1957)
            Bv0 = ops.apply_B(sol0["v"])
            bcB = ops.bc_B(t)
            v0f = tuple(
                tuple(Bv0[d][c] + bcB[d][c] for c in range(dim))
                for d in range(dim)
            )

            rhs = self._form_rhs(sol0, state["phalf"], t, is_first_step)
            if self.body_force is not None:
                f = self.body_force(sol0, t)
                rhs["v"] = tuple(
                    rhs["v"][c] + self.dt * f[c] for c in range(dim)
                )
        with span("step.coeffs"):
            diagA = ops.diag_A(U0, v0f)
            Acoeffs = ops.build_momentum_operator(U0, v0f)
            pre = self._precond_ctx(Acoeffs, diagA, U0, v0f)
        x0 = None
        if self.cfg.warm_start:
            # start from the old velocities and a zero pressure increment
            x0 = {"v": tuple(sol0["v"]), "U": tuple(U0),
                  "p": torch.zeros_like(sol0["p"])}
        with span("step.outer"):
            res = self._outer_solve(rhs, Acoeffs, diagA, pre, x0)
        profiling.count("iters.outer", res.iters)
        x = res.x
        with span("step.project"):
            dp = self._project_p(x["p"])

            if is_first_step:
                p_new = sol0["p"] + 2.0 * dp
                phalf_new = sol0["p"] + dp
            else:
                p_new = state["phalf"] + 1.5 * dp
                phalf_new = state["phalf"] + dp

        new_state = {
            "v": tuple(x["v"]),
            "U": tuple(x["U"]),
            "p": p_new,
            "phalf": phalf_new,
        }
        converged = (
            torch.isfinite(res.rnorm) if self.cfg.converged_skip
            else res.converged
        )
        diag = {
            "ksp_iters": res.iters,
            "ksp_rnorm": res.rnorm,
            "converged": converged,
        }
        if self.cfg.diag_rhs_norm:
            diag["rhs_norm"] = self._norm(rhs)
        return new_state, diag

    def step(self, state, t, step_index: int):
        """One time step (the first step uses q = p0, later steps
        q = phalf)."""
        return self._step_impl(state, float(t), step_index == 0)

    def multi_step(self, state, t, n: int):
        """n non-first steps in a loop that reads nothing back to the
        host. Returns (state, diag of the last step with the worst
        rnorm and the conjunction of convergence over the batch)."""
        t = float(t)
        rn_max = conv_all = None
        diag = None
        for k in range(int(n)):
            state, diag = self._step_impl(state, t + k * self.dt, False)
            rn = diag["ksp_rnorm"]
            rn_max = rn if rn_max is None else torch.maximum(rn_max, rn)
            conv = diag["converged"]
            conv_all = conv if conv_all is None else torch.logical_and(
                conv_all, conv
            )
        return state, {
            "ksp_iters": diag["ksp_iters"],
            "ksp_rnorm": rn_max,
            "converged": conv_all,
        }
