"""FD tutorials: small PDE solvers built on the operator algebra
(counterpart of fluca_tpu.tutorials.fd).

Reference: fluca/tutorials/fd/ex1.c-ex4.c. Each returns its solution (a
numpy array) and performs the same physics self-checks the reference
encodes with PetscCheck (boundedness, TVD property, conservation),
raising AssertionError when one fails. Each runs on ``device`` (default
"cuda") in ``dtype`` (default float64, as fluca_tpu's); in float32 the
checks' tolerances of 1e-10 to 1e-6 become F32_TOL, float32's
resolution for these sums of ~10^2-10^4 terms.

  ex1: 1-D steady convection-diffusion (the reference solves with
       SNES; linear problem -> one Krylov solve here)
  ex2: 1-D unsteady convection with TVD limiter (TS/SSP -> SSP-RK3)
  ex3: 2-D unsteady convection-diffusion (TS -> SSP-RK3)
  ex4: 1-D viscous Burgers via scale-by-field nonlinearity
       (FlucaFDScaleSetVector per step -> ScaledFieldOp)

    python -m fluca_tpu_torch.tutorials.fd [--device cuda] [--dtype float64]

runs the four and prints one JSON line per tutorial (its output's size,
norm, extremes and the seconds it took).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ops.fd import (
    FDBC,
    FDBCType,
    ScaledFieldOp,
    derivative,
    fd_scale,
    fd_sum,
)
from fluca_tpu_torch.ops.tvd import TVDOp
from fluca_tpu_torch.solvers.krylov import bicgstab

F32_TOL = 1e-5
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _tol(dtype, f64_tol):
    """A self-check's tolerance: fluca_tpu's in float64, at least F32_TOL
    in float32."""
    return f64_tol if dtype == torch.float64 else max(f64_tol, F32_TOL)


def _require(ok, what):
    if not ok:
        raise AssertionError(what)


def _host(x) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def _ssp_rk3(rhs, u, dt, nsteps):
    """Shu-Osher SSP-RK3 (the TSSSP scheme the reference tutorials
    use)."""
    for _ in range(nsteps):
        u1 = u + dt * rhs(u)
        u2 = 0.75 * u + 0.25 * (u1 + dt * rhs(u1))
        u = u / 3.0 + 2.0 / 3.0 * (u2 + dt * rhs(u2))
    return u


def ex1_steady_convection_diffusion(N=64, u_vel=1.0, gamma=0.05, *, device="cuda",
                                    dtype=torch.float64):
    """u dphi/dx = Gamma d2phi/dx2, phi(0)=0, phi(1)=1.
    Analytic: (exp(u x / G) - 1) / (exp(u / G) - 1)."""
    m = CartMesh.create((N,))
    m.set_uniform_coordinates(0.0, 1.0)
    bcs = [FDBC(FDBCType.DIRICHLET, 0.0), FDBC(FDBCType.DIRICHLET, 1.0)]
    conv = fd_scale(derivative(m, 0, 1, 2, bcs=bcs), u_vel)
    diff = fd_scale(derivative(m, 0, 2, 2, bcs=bcs), gamma)

    def op(phi):
        return conv.apply(phi, include_const=False) - diff.apply(
            phi, include_const=False
        )

    # move the bc constant terms to the rhs: op(phi) = -(const terms)
    zero = torch.zeros(N, dtype=dtype, device=device)
    rhs = -(conv.apply(zero) - diff.apply(zero))
    res = bicgstab(op, rhs, rtol=1e-10, maxiter=500)
    phi = _host(res.x)

    c = m.centers(0)
    exact = (np.exp(u_vel * c / gamma) - 1.0) / (
        np.exp(u_vel / gamma) - 1.0
    )
    # self-checks: boundedness + accuracy
    tol = _tol(dtype, 1e-8)
    _require(phi.min() > -tol and phi.max() < 1.0 + tol, "ex1: phi leaves [0, 1]")
    _require(np.max(np.abs(phi - exact)) < 0.05, "ex1: phi far from the exact solution")
    return phi, exact


def ex2_unsteady_convection_tvd(N=128, limiter="vanleer", cfl=0.4,
                                t_final=0.25, *, device="cuda", dtype=torch.float64):
    """dphi/dt + u dphi/dx = 0 (u=1, periodic): advect a step profile
    with a TVD flux; self-check: min/max bounds preserved (TVD)."""
    m = CartMesh.create((N,), (True,))
    m.set_uniform_coordinates(0.0, 1.0)
    x = m.centers(0)
    h = 1.0 / N
    dt = cfl * h
    nsteps = int(t_final / dt)
    tvd = TVDOp(m, 0, limiter=limiter)
    vel = torch.ones(N, dtype=dtype, device=device)

    def rhs(phi):
        flux = tvd.apply(phi, vel) * vel  # face flux u*phi_face
        return -(torch.roll(flux, -1) - flux) / h

    phi0 = torch.as_tensor(np.where((x > 0.25) & (x < 0.5), 1.0, 0.0), dtype=dtype,
                           device=device)
    phi = _host(_ssp_rk3(rhs, phi0, dt, nsteps))
    # TVD self-checks: boundedness + mass conservation
    tol = _tol(dtype, 1e-10)
    _require(phi.min() > -tol and phi.max() < 1.0 + tol, "ex2: TVD bounds violated")
    np.testing.assert_allclose(phi.sum(), float(phi0.sum()), rtol=tol)
    return phi


def ex3_convection_diffusion_2d(N=32, u=(1.0, 0.5), gamma=0.01,
                                t_final=0.1, cfl=0.3,
                                limiter="vanleer", *, device="cuda", dtype=torch.float64):
    """dphi/dt + div(u phi) = Gamma lap(phi), periodic; TVD convective
    fluxes keep the solution bounded (the reference's ex3 uses the
    secondordertvd operator for convection)."""
    m = CartMesh.create((N, N), (True, True))
    m.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    h = 1.0 / N
    dt = min(cfl * h / max(abs(u[0]), abs(u[1])), 0.2 * h * h / gamma)
    nsteps = max(int(t_final / dt), 1)
    tvx = TVDOp(m, 0, limiter=limiter)
    tvy = TVDOp(m, 1, limiter=limiter)
    velx = torch.full((N, N), u[0], dtype=dtype, device=device)
    vely = torch.full((N, N), u[1], dtype=dtype, device=device)
    lap = fd_sum(derivative(m, 0, 2, 2), derivative(m, 1, 2, 2))

    def rhs(phi):
        fx = u[0] * tvx.apply(phi, velx)
        fy = u[1] * tvy.apply(phi, vely)
        conv = (torch.roll(fx, -1, 0) - fx) / h + (
            torch.roll(fy, -1, 1) - fy
        ) / h
        return -conv + gamma * lap.apply(phi)

    cx, cy = m.centers(0), m.centers(1)
    X, Y = np.meshgrid(cx, cy, indexing="ij")
    phi0 = torch.as_tensor(np.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2) / 0.01), dtype=dtype,
                           device=device)
    phi = _host(_ssp_rk3(rhs, phi0, dt, nsteps))
    # diffusion + advection conserve mass (periodic) and reduce max
    np.testing.assert_allclose(phi.sum(), float(phi0.sum()), rtol=_tol(dtype, 1e-8))
    _require(phi.max() < float(phi0.max()), "ex3: the maximum grew")
    _require(phi.min() > -_tol(dtype, 1e-8), "ex3: phi went negative")
    return phi


def ex4_viscous_burgers(N=128, nu=0.01, t_final=0.3, cfl=0.3, *, device="cuda",
                        dtype=torch.float64):
    """dphi/dt + phi dphi/dx = nu d2phi/dx2 (periodic), nonlinearity
    via runtime scale-by-field (reference tutorials/fd/ex4.c +
    FlucaFDScaleSetVector)."""
    m = CartMesh.create((N,), (True,))
    m.set_uniform_coordinates(0.0, 1.0)
    h = 1.0 / N
    x = m.centers(0)
    d1 = derivative(m, 0, 1, 2)
    d2 = derivative(m, 0, 2, 2)
    conv = ScaledFieldOp(d1)

    def rhs(phi):
        conv.set_field(phi)  # phi * dphi/dx
        return -conv(phi) + nu * d2.apply(phi)

    phi0 = torch.as_tensor(1.0 + 0.5 * np.sin(2 * np.pi * x), dtype=dtype, device=device)
    dt = cfl * h / 1.5
    nsteps = int(t_final / dt)
    phi = _host(_ssp_rk3(rhs, phi0, dt, nsteps))
    # Burgers with viscosity: bounded by initial range, mass conserved
    tol = _tol(dtype, 1e-6)
    _require(phi.min() > 0.5 - tol and phi.max() < 1.5 + tol, "ex4: phi leaves [0.5, 1.5]")
    np.testing.assert_allclose(phi.mean(), 1.0, rtol=tol)
    return phi


TUTORIALS = {
    "ex1": lambda **kw: ex1_steady_convection_diffusion(**kw)[0],
    "ex2": ex2_unsteady_convection_tvd,
    "ex3": ex3_convection_diffusion_2d,
    "ex4": ex4_viscous_burgers,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--dtype", default="float64", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    from fluca_tpu_torch.bench import device_info
    from fluca_tpu_torch.ns.ns import check_device

    dev = check_device(args.device)
    for name, fn in TUTORIALS.items():
        t0 = time.perf_counter()
        phi = fn(device=dev, dtype=DTYPES[args.dtype])
        print(json.dumps({"tutorial": name, "dtype": args.dtype, "shape": list(phi.shape),
                          "norm": float(np.linalg.norm(phi)), "min": float(phi.min()),
                          "max": float(phi.max()), "seconds": time.perf_counter() - t0,
                          "device": device_info(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
