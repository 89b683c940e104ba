"""Krylov solvers over trees of tensors.

Counterpart of fluca_tpu.solvers.krylov. A "tree" is a tensor, or a
tuple/list/dict nesting of tensors (the coupled NS state is
{"v": tuple, "U": tuple, "p": tensor}).

Each solver is one loop. With ``rtol=None`` it runs exactly
``maxiter`` iterations and never reads a value back to the host (the
fixed-budget production presets: no device synchronisation inside a
step). With a tolerance it checks ``rnorm > max(rtol * |b|, atol)``
before each iteration, one host read per iteration. The two forms make
the same iterates until the tolerance is met. Every host read goes
through ``profiling.read`` under its site (``<solver>.<value>``), which
counts it while tracing is on.

All solvers accept:
  dot     : the tree inner product (``tree_dot``; under a rank-held grid
            the local sum added over the ranks)
  A       : tree -> tree linear operator
  b       : right-hand side tree
  x0      : initial guess (zeros if None)
  M       : preconditioner, tree -> tree (right preconditioning for
            FGMRES/GCR, so the convergence norm is the unpreconditioned
            residual — the reference default KSP_NORM_UNPRECONDITIONED,
            fluca/src/ns/interface/nssol.c:24-25)
  project : optional nullspace projection applied to keep iterates in
            range(A) (mean subtraction for the singular pressure
            Poisson problem, reference nsbasic.c:215-244)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from fluca_tpu_torch.utils import profiling


# ----------------------------------------------------------------------
# tree vector algebra
# ----------------------------------------------------------------------

def tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"not a tree of tensors: {type(t0)}")


def tree_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [x for t in tree for x in tree_leaves(t)]


def tree_dot(a, b):
    """Tree inner product (a 0-d tensor on the leaves' device).
    Leaves narrower than 32 bits (the bf16 inner solves) sum their
    products, rounded to the leaf dtype, in float32: ``torch.dot`` on
    bf16 returns bf16, which loses the O(n) sum
    (fluca_tpu.solvers.krylov.tree_dot)."""
    tot = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.dtype.itemsize < 4:
            d = torch.sum((x * y).to(torch.float32))
        else:
            d = torch.dot(x.reshape(-1), y.reshape(-1))
        tot = d if tot is None else tot + d
    return tot


def tree_norm(a):
    return torch.sqrt(tree_dot(a, a))


def _scalar_as(alpha, x):
    """A 0-d tensor scalar in ``x``'s dtype, so that the float32 sums
    of ``tree_dot`` keep bf16 vectors in bf16; a number as it is."""
    return alpha.to(x.dtype) if isinstance(alpha, torch.Tensor) else alpha


def tree_axpy(alpha, x, y):
    """y + alpha * x (alpha a number or 0-d tensor, cast to each
    leaf's dtype)."""
    return tree_map(lambda xi, yi: yi + _scalar_as(alpha, xi) * xi, x, y)


def tree_scale(alpha, x):
    return tree_map(lambda xi: _scalar_as(alpha, xi) * xi, x)


def tree_sub(x, y):
    return tree_map(lambda a, b: a - b, x, y)


def tree_add(x, y):
    return tree_map(lambda a, b: a + b, x, y)


def tree_zeros_like(x):
    return tree_map(torch.zeros_like, x)


@dataclass
class KrylovResult:
    x: Any
    iters: Any  # int
    rnorm: Any  # 0-d tensor (or float for fgmres)
    converged: Any  # 0-d bool tensor


def _identity(x):
    return x


def _nz(x):
    """x with zeros replaced by ones (a guarded divisor)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def _norm(dot, a):
    return torch.sqrt(dot(a, a))


def _tolerance(b, rtol, atol, dot, solver) -> float | None:
    """max(rtol * |b|, atol) on the host (a host read at the site
    ``<solver>.tol``), or None for a fixed budget."""
    if rtol is None:
        return None
    return max(rtol * profiling.read(_norm(dot, b), f"{solver}.tol"), atol)


def _finish(x, k, rnorm, tol):
    converged = (
        torch.isfinite(rnorm) if tol is None else rnorm <= tol
    )
    return KrylovResult(x=x, iters=k, rnorm=rnorm, converged=converged)


# ----------------------------------------------------------------------
# Conjugate gradient (SPD; the pressure-Poisson workhorse)
# ----------------------------------------------------------------------

def cg(
    A: Callable,
    b,
    x0=None,
    *,
    maxiter: int,
    rtol: Optional[float] = None,
    atol: float = 0.0,
    M: Optional[Callable] = None,
    project: Optional[Callable] = None,
    dot: Callable = tree_dot,
) -> KrylovResult:
    M = M or _identity
    P = project or _identity
    b = P(b)
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = P(tree_sub(b, A(x0)))
    tol = _tolerance(b, rtol, atol, dot, "cg")
    z = P(M(r))
    p = z
    rz = dot(r, z)
    rnorm = None if tol is None else _norm(dot, r)
    k = 0
    while k < maxiter and (tol is None or profiling.read(rnorm, "cg.rnorm") > tol):
        Ap = P(A(p))
        alpha = rz / _nz(dot(p, Ap))
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = P(M(r))
        rz_new = dot(r, z)
        beta = rz_new / _nz(rz)
        p = tree_axpy(beta, p, z)
        rz = rz_new
        k += 1
        if tol is not None:
            rnorm = _norm(dot, r)
    if tol is None:
        rnorm = _norm(dot, r)
    return _finish(P(x), k, rnorm, tol)


# ----------------------------------------------------------------------
# BiCGStab (nonsymmetric; momentum-block solves)
# ----------------------------------------------------------------------

def bicgstab(
    A: Callable,
    b,
    x0=None,
    *,
    maxiter: int,
    rtol: Optional[float] = None,
    atol: float = 0.0,
    M: Optional[Callable] = None,
    dot: Callable = tree_dot,
) -> KrylovResult:
    M = M or _identity
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, A(x0))
    tol = _tolerance(b, rtol, atol, dot, "bicgstab")
    rhat = r
    p = tree_zeros_like(b)
    v = tree_zeros_like(b)
    one = torch.ones((), dtype=tree_leaves(b)[0].dtype,
                     device=tree_leaves(b)[0].device)
    rho = alpha = omega = one
    rnorm = None if tol is None else _norm(dot, r)
    k = 0
    while k < maxiter and (tol is None or profiling.read(rnorm, "bicgstab.rnorm") > tol):
        rho_new = dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = tree_axpy(beta, tree_axpy(-omega, v, p), r)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _nz(dot(rhat, v))
        s = tree_axpy(-alpha, v, r)
        shat = M(s)
        t = A(shat)
        omega = dot(t, s) / _nz(dot(t, t))
        x = tree_axpy(alpha, phat, tree_axpy(omega, shat, x))
        r = tree_axpy(-omega, t, s)
        rho = rho_new
        k += 1
        if tol is not None:
            rnorm = _norm(dot, r)
    if tol is None:
        rnorm = _norm(dot, r)
    return _finish(x, k, rnorm, tol)


# ----------------------------------------------------------------------
# Flexible GCR (generalized conjugate residual), fixed budget
# ----------------------------------------------------------------------

def gcr(
    A: Callable,
    b,
    x0=None,
    *,
    maxiter: int,
    M: Optional[Callable] = None,
    dot: Callable = tree_dot,
) -> KrylovResult:
    """Flexible GCR: minimizes the residual over the same Krylov space
    as FGMRES, tree-native, with a residual norm that cannot grow under
    a rough preconditioner (the robust outer of the fixed-budget
    production presets). Exactly ``maxiter`` iterations; no host
    reads."""
    M = M or _identity
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, A(x0))
    zs, ws = [], []
    for _ in range(maxiter):
        z = M(r)
        w = A(z)
        # orthogonalize w against the previous (normalized) directions
        for zi, wi in zip(zs, ws):
            beta = dot(w, wi)
            w = tree_axpy(-beta, wi, w)
            z = tree_axpy(-beta, zi, z)
        inv = torch.rsqrt(_nz(dot(w, w)))
        w = tree_scale(inv, w)
        z = tree_scale(inv, z)
        alpha = dot(w, r)
        x = tree_axpy(alpha, z, x)
        r = tree_axpy(-alpha, w, r)
        zs.append(z)
        ws.append(w)
    return _finish(x, maxiter, _norm(dot, r), None)


# ----------------------------------------------------------------------
# Flexible GMRES (right-preconditioned; the reference's outer solver,
# -ns_ksp_type fgmres with PCABF)
# ----------------------------------------------------------------------

def fgmres(
    A: Callable,
    b,
    x0=None,
    *,
    maxiter: int = 300,
    rtol: float = 1e-5,
    atol: float = 0.0,
    restart: int = 30,
    M: Optional[Callable] = None,
    dot: Callable = tree_dot,
) -> KrylovResult:
    """Restarted flexible GMRES with modified Gram-Schmidt. The basis
    is kept per leaf (lists of trees), so no flattened (restart, n)
    buffer is formed. The Hessenberg column goes to the host once per
    iteration, where the Givens rotations and the small triangular
    solve run in float64; the returned ``rnorm`` is the rotated
    residual estimate |g[nit]|, as in the reference."""
    M = M or _identity
    x = tree_zeros_like(b) if x0 is None else x0
    tol = _tolerance(b, rtol, atol, dot, "fgmres")
    m = restart
    max_cycles = (maxiter + m - 1) // m
    rnorm = profiling.read(_norm(dot, tree_sub(b, A(x))), "fgmres.rnorm")
    its = 0
    cyc = 0
    while cyc < max_cycles and rnorm > tol:
        r = tree_sub(b, A(x))
        beta_t = _norm(dot, r)
        beta = profiling.read(beta_t, "fgmres.beta")
        V = [tree_map(lambda a: a / _nz(beta_t), r)]
        Z = []
        H = []  # columns, host floats
        cs, sn = [], []
        g = [beta] + [0.0] * m
        nit = 0
        done = beta <= tol
        while nit < m and not done:
            j = nit
            z = M(V[j])
            w = A(z)
            hcol_t = []
            for i in range(j + 1):
                hij = dot(V[i], w)
                w = tree_axpy(-hij, V[i], w)
                hcol_t.append(hij)
            hlast = _norm(dot, w)
            hcol_t.append(hlast)
            hcol = profiling.read(torch.stack(hcol_t).double(), "fgmres.hcol",
                                  torch.Tensor.tolist)
            V.append(tree_map(lambda a: a / _nz(hlast), w))
            Z.append(z)
            # previous Givens rotations on the new column
            for i in range(j):
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = hi
            denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = hcol[j] / (denom if denom != 0 else 1.0)
            s = hcol[j + 1] / (denom if denom != 0 else 1.0)
            hcol[j] = c * hcol[j] + s * hcol[j + 1]
            hcol[j + 1] = 0.0
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            cs.append(c)
            sn.append(s)
            H.append(hcol)
            nit = j + 1
            done = abs(g[j + 1]) <= tol
        # back-substitution on the nit x nit triangular system
        y = [0.0] * nit
        for j in range(nit - 1, -1, -1):
            acc = sum(H[k][j] * y[k] for k in range(j + 1, nit))
            hj = H[j][j]
            y[j] = (g[j] - acc) / (hj if hj != 0 else 1.0)
        for j in range(nit):
            x = tree_axpy(y[j], Z[j], x)
        rnorm = abs(g[nit])
        its += nit
        cyc += 1
    ref = tree_leaves(b)[0]
    rn = torch.tensor(rnorm, dtype=ref.dtype, device=ref.device)
    return _finish(x, its, rn, tol)
