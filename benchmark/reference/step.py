"""One linearized Crank-Nicolson time step of the plain reference: a
frozen copy of the port's ``ns/cnlinear.py`` on one whole grid, with
the chain stages (the coupled apply's G/T/R/D epilogue, the ABF pre
and post stages) on the banded operators, every momentum A-apply on
the banded tables and every Poisson level on banded sums.

One step solves the coupled saddle system

    [ A   0   G  ] [ v  ]   [ momrhs    ]
    [ -T  I  -R  ] [ U  ] = [ interprhs ]
    [ 0   D   0  ] [ p' ]   [ 0         ]

with a fixed-budget GCR or FGMRES to a tolerance, preconditioned by the
approximate block factorization (ABF):

    v* = kspA^-1 momrhs           (Jacobi sweeps, BiCGStab or GCR)
    U* = interprhs + T v*
    p  = kspS^-1 (contrhs - D U*) (CG or V-cycle Richardson + multigrid)
    v  = v* - G p,   U = U* - Gst p

and updates the pressure by extrapolation: on the first step p <- p0 +
2 dp, phalf <- p0 + dp, later p <- phalf + 1.5 dp, phalf <- phalf + dp.

``precond_dtype`` ("bfloat16") runs the momentum solve (and with scope
"both" the Schur solve) of the preconditioner in that dtype: its fields
rounded to it, its arithmetic in float32, every operation's result
rounded to it; the outer iteration, the chain and the state stay in the
step's dtype. The ``solver`` dict takes the fields of the port's
``CNLinearConfig`` by the same names.
"""

from __future__ import annotations

import torch

from . import krylov as K
from .mg import PoissonMG
from .operators import NSOperators

# a tolerance at or below this is a fixed budget
FIXED_BUDGET_RTOL = 1e-20

DEFAULTS = {
    "rtol": 1e-5, "restart": 30, "maxiter": 200,
    "mom_rtol": 1e-5, "mom_maxiter": 100, "schur_rtol": 1e-5, "schur_maxiter": 200,
    "warm_start": False, "converged_skip": False,
    "outer_type": "fgmres", "mom_solver": "bicgstab", "schur_solver": "cg",
    "mom_omega": 1.0, "precond_dtype": None, "precond_scope": "both",
}
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def production(outer=3, mom=8, schur=6) -> dict:
    """The fixed-budget preset: GCR outer, BiCGStab momentum, CG Schur."""
    return {"rtol": 1e-30, "maxiter": outer, "restart": outer, "converged_skip": True,
            "mom_rtol": 1e-30, "mom_maxiter": mom, "schur_rtol": 1e-30,
            "schur_maxiter": schur, "outer_type": "gcr"}


def solver_config(spec: dict) -> dict:
    """The full solver settings from a spec: ``preset`` "production"
    (with ``outer``, ``mom``, ``schur``) or "default" (the tolerance
    defaults), then any field of DEFAULTS by name."""
    spec = dict(spec)
    preset = spec.pop("preset", "default")
    cfg = dict(DEFAULTS)
    if preset == "production":
        cfg.update(production(spec.pop("outer"), spec.pop("mom"), spec.pop("schur")))
    elif preset != "default":
        raise ValueError(f"unknown solver preset {preset!r}")
    unknown = set(spec) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown solver fields {sorted(unknown)}")
    cfg.update(spec)
    return cfg


class ReferenceStep:
    """The plain step on ``mesh`` with ``bcs`` in ``dtype`` on
    ``device``; ``body_force(state, t)`` (cell vector or None) is added to
    the momentum right-hand side as dt * f."""

    def __init__(self, mesh, bcs, rho, mu, dt, solver: dict, dtype, device, body_force=None):
        self.cfg = solver_config(solver)
        self.dtype, self.device = dtype, torch.device(device)
        self.dt, self.rho, self.mu = float(dt), float(rho), float(mu)
        self.mesh, self.bcs = mesh, list(bcs)
        self.ops = NSOperators(mesh, bcs, rho, mu, dt, dtype, device)
        self.mg = PoissonMG(mesh, bcs, scale=dt / rho, dtype=dtype, device=device)
        self.pin_pressure = not self.ops.has_pressure_outlet
        self.body_force = body_force
        self._pre = None
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False

    # -- helpers -----------------------------------------------------------
    def _budget(self, rtol):
        return None if self.cfg["converged_skip"] and rtol <= FIXED_BUDGET_RTOL else rtol

    def _project_p(self, p, mg):
        if not self.pin_pressure:
            return p
        vol = mg.levels[0].vol
        acc = torch.promote_types(p.dtype, torch.float32)
        mean = torch.sum((vol * p).to(acc)) / torch.sum(vol.to(acc))
        return p - mean.to(p.dtype)

    def _pre_resources(self):
        """(dtype, f32 operators for its A-apply, its Schur hierarchy or
        None) of the reduced-precision preconditioner, built once."""
        if self._pre is None:
            pdt = DTYPES[self.cfg["precond_dtype"]]
            acc = torch.float32
            ops = self.ops if self.dtype == acc else NSOperators(
                self.mesh, self.bcs, self.rho, self.mu, self.dt, acc, self.device)
            mg = None
            if self.cfg["precond_scope"] == "both":
                mg = PoissonMG(self.mesh, self.bcs, scale=self.dt / self.rho, dtype=pdt,
                               device=self.device)
            self._pre = (pdt, ops, mg)
        return self._pre

    # -- inner solves -------------------------------------------------------
    def _solve_momentum(self, rhs, A, diagA):
        cfg = self.cfg
        inv_diag = tuple(1.0 / d for d in diagA)
        dim = len(rhs)

        def M(r):
            return tuple(inv_diag[c] * r[c] for c in range(dim))

        if cfg["mom_solver"] == "gcr":
            return K.gcr(A, rhs, maxiter=cfg["mom_maxiter"], M=M).x
        if cfg["mom_solver"] == "jacobi":
            w = cfg["mom_omega"]
            x = tuple(w * inv_diag[c] * rhs[c] for c in range(dim))
            for _ in range(cfg["mom_maxiter"] - 1):
                Ax = A(x)
                x = tuple(x[c] + w * inv_diag[c] * (rhs[c] - Ax[c]) for c in range(dim))
            return x
        if cfg["mom_solver"] != "bicgstab":
            raise ValueError(f"unknown momentum solver {cfg['mom_solver']!r}")
        return K.bicgstab(A, rhs, rtol=self._budget(cfg["mom_rtol"]),
                          maxiter=cfg["mom_maxiter"], M=M).x

    def _solve_schur(self, rhs_p, mg):
        cfg = self.cfg

        def proj(p):
            return self._project_p(p, mg)

        b = mg.scale_rhs(rhs_p)
        if cfg["schur_solver"] == "vcycle":
            lvl0 = mg.levels[0]
            p = mg.precondition(b)
            for _ in range(cfg["schur_maxiter"] - 1):
                p = p + mg.precondition(mg._residual(lvl0, p, b))
            return proj(p) if self.pin_pressure else p
        if cfg["schur_solver"] != "cg":
            raise ValueError(f"unknown Schur solver {cfg['schur_solver']!r}")
        return K.cg(mg.apply_op, b, rtol=self._budget(cfg["schur_rtol"]),
                    maxiter=cfg["schur_maxiter"], M=mg.precondition,
                    project=proj if self.pin_pressure else None).x

    # -- the chain stages on the banded operators ------------------------
    def _coupled_apply(self, x, U0, v0f):
        ops = self.ops
        v, U, p = x["v"], x["U"], x["p"]
        Av = ops.apply_A(v, U0, v0f)
        Gp, Tv, Rp = ops.apply_G(p), ops.apply_T(v), ops.apply_R(p)
        return {"v": tuple(Av[c] + Gp[c] for c in range(ops.dim)),
                "U": tuple(U[d] - Tv[d] - Rp[d] for d in range(ops.dim)),
                "p": ops.apply_D(U)}

    def _abf_apply(self, r, U0, v0f, diagA):
        ops, cfg = self.ops, self.cfg
        if cfg["precond_dtype"] is None:
            vstar = self._solve_momentum(r["v"], lambda v: ops.apply_A(v, U0, v0f), diagA)
            mg = self.mg
        else:
            pdt, aops, pmg = self._pre_resources()
            acc = aops.dtype
            U0p = tuple(F.to(pdt).to(acc) for F in U0)
            v0fp = tuple(tuple(F.to(pdt).to(acc) for F in row) for row in v0f)

            def A(v):
                out = aops.apply_A(tuple(x.to(acc) for x in v), U0p, v0fp)
                return tuple(x.to(pdt) for x in out)

            vstar = self._solve_momentum(tuple(x.to(pdt) for x in r["v"]), A,
                                         tuple(d.to(pdt) for d in diagA))
            vstar = tuple(x.to(self.dtype) for x in vstar)
            mg = pmg or self.mg
        Tv = ops.apply_T(vstar)
        Ustar = tuple(r["U"][d] + Tv[d] for d in range(ops.dim))
        rp = r["p"] - ops.apply_D(Ustar)
        if mg is self.mg:
            p = self._solve_schur(rp, mg)
        else:
            p = self._solve_schur(rp.to(mg.dtype), mg).to(self.dtype)
        Gp, Gstp = ops.apply_G(p), ops.apply_Gst(p)
        return {"v": tuple(vstar[c] - Gp[c] for c in range(ops.dim)),
                "U": tuple(Ustar[d] - Gstp[d] for d in range(ops.dim)), "p": p}

    def _form_rhs(self, sol0, phalf, t, first):
        ops = self.ops
        dim, dt, rho, mu = ops.dim, self.dt, self.rho, self.mu
        v0 = sol0["v"]
        s_visc = 0.5 * mu * dt / rho
        s_g = dt / rho
        q, t_q = (sol0["p"], t) if first else (phalf, t - 0.5 * dt)
        Gq, bcGq = ops.apply_G(q), ops.bc_G(t_q)
        Lv0, bcLt, bcLt1 = ops.apply_L(v0), ops.bc_L(t), ops.bc_L(t + dt)
        bcC = ops.bc_C(t, t + dt)
        momrhs = tuple(v0[c] + s_visc * (Lv0[c] + bcLt[c]) - dt * bcC[c]
                       - (Gq[c] + s_g * bcGq[c]) + s_visc * bcLt1[c] for c in range(dim))
        bcT1, bcGp = ops.bc_T(t + dt), ops.bc_G(t + 0.5 * dt)
        bcGstp, bcGstq = ops.bc_Gst(t + 0.5 * dt), ops.bc_Gst(t_q)
        TdG = ops.apply_T(tuple(s_g * (bcGq[c] - bcGp[c]) for c in range(dim)))
        interprhs = tuple(bcT1[d] - TdG[d] + s_g * (bcGstq[d] - bcGstp[d]) for d in range(dim))
        contrhs = torch.zeros(self.mesh.cell_shape, dtype=self.dtype, device=self.device)
        return {"v": momrhs, "U": interprhs, "p": contrhs}

    # -- one step -----------------------------------------------------------
    def step(self, state, t, first: bool):
        """(new state, diagnostics) of one step from ``state`` at time
        ``t``; ``first``: the first step of a run (q = p0)."""
        ops, cfg = self.ops, self.cfg
        dim = ops.dim
        U0 = state["U"]
        Bv0, bcB = ops.apply_B(state["v"]), ops.bc_B(t)
        v0f = tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(dim)) for d in range(dim))
        rhs = self._form_rhs(state, state["phalf"], t, first)
        if self.body_force is not None:
            f = self.body_force(state, t)
            rhs["v"] = tuple(rhs["v"][c] + self.dt * f[c] for c in range(dim))
        diagA = ops.diag_A(U0, v0f)

        def A(x):
            return self._coupled_apply(x, U0, v0f)

        def M(r):
            return self._abf_apply(r, U0, v0f, diagA)

        if cfg["outer_type"] == "gcr":
            res = K.gcr(A, rhs, maxiter=cfg["maxiter"], M=M)
        elif cfg["outer_type"] == "fgmres":
            x0 = None
            if cfg["warm_start"]:
                x0 = {"v": tuple(state["v"]), "U": tuple(U0),
                      "p": torch.zeros_like(state["p"])}
            res = K.fgmres(A, rhs, x0=x0, rtol=cfg["rtol"], restart=cfg["restart"],
                           maxiter=cfg["maxiter"], M=M)
        else:
            raise ValueError(f"unknown outer solver {cfg['outer_type']!r}")
        x = res.x
        dp = self._project_p(x["p"], self.mg)
        if first:
            p_new, phalf_new = state["p"] + 2.0 * dp, state["p"] + dp
        else:
            p_new, phalf_new = state["phalf"] + 1.5 * dp, state["phalf"] + dp
        new = {"v": tuple(x["v"]), "U": tuple(x["U"]), "p": p_new, "phalf": phalf_new}
        return new, {"ksp_iters": res.iters, "ksp_rnorm": res.rnorm}
