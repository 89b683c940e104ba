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
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.operators import NSOperators
from fluca_tpu_torch.solvers.krylov import (
    KrylovResult, bicgstab, cg, fgmres, gcr, tree_add, tree_norm, tree_sub,
)
from fluca_tpu_torch.solvers.mg import PoissonMG
from fluca_tpu_torch.utils import config

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
    # Atilde approximations in the ABF factorization
    # (-pc_abf_schur_ainv_type / -pc_abf_upper_ainv_type,
    # abfpc.c:240-252); 'id' is the fractional-step limit
    schur_ainv: str = "id"      # id | diag | rowsum
    upper_ainv: str = "id"
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
    ):
        self.dtype = config.resolve_dtype(dtype)
        self.device = torch.device(device)
        self.cfg = cfg or CNLinearConfig()
        self.ops = NSOperators(mesh, bcs, rho, mu, dt, self.dtype, self.device)
        self.mesh = mesh
        self.dt = float(dt)
        self.rho = float(rho)
        self.mu = float(mu)
        # multigrid hierarchy for Shat = vol .* (-D Gst)
        self.mg = PoissonMG(mesh, bcs, scale=dt / rho, dtype=self.dtype,
                            device=self.device)
        self.pin_pressure = not self.ops.has_pressure_outlet
        # the precond_dtype multigrid twin, built on first use
        # (_pre_resources)
        self._pre16 = None
        # optional momentum body-force hook: f(state0, t) -> cell
        # vector; added to the momentum RHS as dt * f (the channel's
        # mean-pressure-gradient forcing)
        self.body_force = None

    # -- state ---------------------------------------------------------
    def zero_state(self) -> dict:
        m, dev, dt = self.mesh, self.device, self.dtype
        return {
            "v": m.zeros_cell_vector(dev, dt),
            "U": m.zeros_face(dev, dt),
            "p": m.zeros_cell(dev, dt),
            "phalf": m.zeros_cell(dev, dt),
        }

    def _budget_rtol(self, rtol):
        """None (a fixed budget, no host reads) where the config skips
        convergence tests and the tolerance can never be met."""
        if self.cfg.converged_skip and rtol <= _FIXED_BUDGET_RTOL:
            return None
        return rtol

    # -- coupled operator & preconditioner ----------------------------
    def _coupled_apply(self, x, Acoeffs):
        ops = self.ops
        v, U, p = x["v"], x["U"], x["p"]
        Av = ops.apply_A_coeffs(v, Acoeffs)
        Gp = ops.apply_G(p)
        Tv = ops.apply_T(v)
        Rp = ops.apply_R(p)
        return {
            "v": tuple(Av[c] + Gp[c] for c in range(ops.dim)),
            "U": tuple(U[d] - Tv[d] - Rp[d] for d in range(ops.dim)),
            "p": ops.apply_D(U),
        }

    def _pressure_mean(self, p, mg=None):
        """Volume-weighted mean of p with the volumes of ``mg`` (the
        solver's hierarchy if None): the product rounded in the
        hierarchy's dtype, the sums in at least float32 (the
        reference's rule for reduced-precision fields,
        cnlinear.py:487-494)."""
        vol = (mg or self.mg).levels[0].vol
        acc = torch.promote_types(p.dtype, torch.float32)
        return (torch.sum((vol * p).to(acc)) / torch.sum(vol.to(acc))).to(
            p.dtype
        )

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
            return gcr(A, rhs_v, maxiter=cfg.mom_maxiter, M=M).x
        if cfg.mom_solver == "jacobi":
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
        return bicgstab(
            A, rhs_v, rtol=self._budget_rtol(cfg.mom_rtol),
            maxiter=cfg.mom_maxiter, M=M,
        ).x

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
                torch.ones(self.mesh.cell_shape, dtype=self.dtype,
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
            return cg(
                mg.apply_op,
                mg.scale_rhs(rhs_p),
                rtol=self._budget_rtol(cfg.schur_rtol),
                maxiter=cfg.schur_maxiter,
                M=mg.precondition,
                project=proj,
            ).x
        ops = self.ops

        def S(p):
            # Stilde p = D T (I - Atilde1^-1) G p - D Gst p, vol-scaled
            # to match the MG preconditioner
            Gp = ops.apply_G(p)
            corr = tuple(Gp[c] - ainv1[c] * Gp[c] for c in range(ops.dim))
            out = ops.apply_D(ops.apply_T(corr)) - ops.apply_DGst(p)
            return mg.scale_rhs(out)

        p = fgmres(
            S, mg.scale_rhs(rhs_p), rtol=cfg.schur_rtol,
            maxiter=cfg.schur_maxiter, restart=30, M=mg.precondition,
        ).x
        return proj(p) if proj else p

    # -- reduced-precision preconditioner ------------------------------
    def _pre_resources(self):
        """The precond_dtype resources, built once: its dtype and, for
        scope "both", a PoissonMG hierarchy in that dtype (None for
        "mom"). None when precond_dtype is off. Raises for
        tolerance-based inner solves, which the reduced-precision path
        does not run (reference cnlinear.py:566-635)."""
        cfg = self.cfg
        if cfg.precond_dtype is None:
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
        """PCApply_ABF (abfpc.c:48-111).

        ``pre`` (from _precond_ctx): the inner solves in reduced
        precision; the T/D/G/Gst chains and the result stay in the
        solver dtype (reference cnlinear.py:685-724)."""
        ops = self.ops
        ainv1 = self._ainv_diag(self.cfg.schur_ainv, Acoeffs, diagA)
        ainv2 = self._ainv_diag(self.cfg.upper_ainv, Acoeffs, diagA)
        if pre is not None and ainv1 is None and ainv2 is None:
            pdt = pre["dtype"]
            vstar = self._solve_momentum(
                tuple(x.to(pdt) for x in r["v"]), pre["Acoeffs"], pre["diagA"]
            )
            vstar = tuple(x.to(self.dtype) for x in vstar)
            Tv = ops.apply_T(vstar)
            Ustar = tuple(r["U"][d] + Tv[d] for d in range(ops.dim))
            rp = r["p"] - ops.apply_D(Ustar)
            if pre["mg"] is None:
                p = self._solve_schur(rp)
            else:
                p = self._solve_schur(rp.to(pdt), mg=pre["mg"]).to(self.dtype)
            Gp = ops.apply_G(p)
            Gstp = ops.apply_Gst(p)
            v = tuple(vstar[c] - Gp[c] for c in range(ops.dim))
            U = tuple(Ustar[d] - Gstp[d] for d in range(ops.dim))
            return {"v": v, "U": U, "p": p}
        vstar = self._solve_momentum(r["v"], Acoeffs, diagA)
        Tv = ops.apply_T(vstar)
        Ustar = tuple(r["U"][d] + Tv[d] for d in range(ops.dim))
        # rhs for Schur: contrhs - D U*
        rp = r["p"] - ops.apply_D(Ustar)
        p = self._solve_schur(rp, ainv1=ainv1)
        Gp = ops.apply_G(p)
        if ainv2 is None:
            # Atilde2 = I: -T G p + R p = -Gst p exactly (R = TG - Gst)
            Gstp = ops.apply_Gst(p)
            v = tuple(vstar[c] - Gp[c] for c in range(ops.dim))
            U = tuple(Ustar[d] - Gstp[d] for d in range(ops.dim))
            return {"v": v, "U": U, "p": p}
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

        contrhs = torch.zeros(self.mesh.cell_shape, dtype=self.dtype,
                              device=self.device)
        return {"v": momrhs, "U": interprhs, "p": contrhs}

    # -- one time step -------------------------------------------------
    def _outer_solve(self, rhs, Acoeffs, diagA, pre=None) -> KrylovResult:
        """The coupled solve; ``pre`` is the reduced-precision context."""
        cfg = self.cfg

        def A(x):
            return self._coupled_apply(x, Acoeffs)

        def M(r):
            return self._abf_apply(r, Acoeffs, diagA, pre)

        if cfg.solve_type == "fsm":
            # classical fractional step: one ABF application is the
            # solve; the coupled residual is reported for diagnostics
            x = M(rhs)
            rnorm = tree_norm(tree_sub(rhs, A(x)))
            return KrylovResult(x=x, iters=1, rnorm=rnorm,
                                converged=torch.isfinite(rnorm))
        if cfg.solve_type != "coupled":
            raise ValueError(f"unknown solve type {cfg.solve_type!r}")
        if cfg.outer_type == "gcr":
            res = gcr(A, rhs, maxiter=cfg.maxiter, M=M)
            res.converged = torch.logical_and(
                res.converged, torch.isfinite(torch.sum(res.x["p"]))
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
            rnorm = tree_norm(rlast)
            return KrylovResult(
                x=x, iters=cfg.maxiter, rnorm=rnorm,
                converged=torch.logical_and(
                    torch.isfinite(rnorm), torch.isfinite(torch.sum(x["p"]))
                ),
            )
        if cfg.outer_type != "fgmres":
            raise ValueError(f"unknown outer solver {cfg.outer_type!r}")
        return fgmres(A, rhs, rtol=cfg.rtol, restart=cfg.restart,
                      maxiter=cfg.maxiter, M=M)

    def _step_impl(self, state, t, is_first_step: bool):
        ops = self.ops
        dim = ops.dim
        sol0 = state
        U0 = sol0["U"]

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
        diagA = ops.diag_A(U0, v0f)
        Acoeffs = ops.build_momentum_operator(U0, v0f)
        pre = self._precond_ctx(Acoeffs, diagA, U0, v0f)
        res = self._outer_solve(rhs, Acoeffs, diagA, pre)
        x = res.x
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
