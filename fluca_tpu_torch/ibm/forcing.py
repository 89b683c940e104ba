"""Direct-forcing immersed boundary coupling to the NS solver
(counterpart of fluca_tpu.ibm.forcing).

Explicit direct forcing (Uhlmann 2005 / Fadlun et al. 2000 family):
per step, the velocity at the markers is interpolated from the old
field, the force needed to bring it to the body velocity in one step
is computed, spread to the grid, and added to the momentum RHS:

  F_k = (U_body(X_k) - E[v^n](X_k)) / dt
  f   = S[F]                  (per component)
  momrhs += dt * f

through the solver's ``body_force`` hook (``CNLinearSolver.body_force``).
Drag and lift follow from the reaction force: -rho * sum_k F_k ds_k.
Nothing here reads a value back to the host. The step's forcing runs in
the span ``ibm.force``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fluca_tpu_torch.ibm.markers import MarkerSet
from fluca_tpu_torch.utils.profiling import span


class DirectForcingIBM:
    def __init__(
        self,
        markers: MarkerSet,
        dt: float,
        body_velocity: Optional[Callable] = None,
        n_iter: int = 4,
    ):
        """``body_velocity(t, X) -> (Nm, dim)``; default: stationary
        body. ``n_iter``: multi-direct-forcing iterations (Richardson
        sweeps on the marker system E dt S F = U_b - E v, Luo et al. /
        Wang-Fan-Luo 2008); each sweep sharpens the boundary enforcement
        at the cost of one spread and one interpolation per component."""
        self.markers = markers
        self.dt = float(dt)
        self.body_velocity = body_velocity
        self.n_iter = int(n_iter)

    def marker_forces(self, state, t):
        """(Nm, dim) direct-forcing strengths from the current state."""
        mk = self.markers
        dim = mk.mesh.dim
        ub = (
            self.body_velocity(t, mk.X)
            if self.body_velocity is not None
            else torch.zeros_like(mk.X)
        )
        F = []
        for c in range(dim):
            v = state["v"][c]
            uc = mk.interpolate(v)
            Fc = (ub[:, c] - uc) / self.dt
            for _ in range(self.n_iter - 1):
                # residual slip of v + dt * S(Fc) at the markers
                slip = ub[:, c] - mk.interpolate(v + self.dt * mk.spread(Fc))
                Fc = Fc + slip / self.dt
            F.append(Fc)
        return torch.stack(F, dim=1)

    def body_force(self, state, t):
        """Cell-vector force field for the momentum RHS hook."""
        with span("ibm.force"):
            F = self.marker_forces(state, t)
            return tuple(self.markers.spread(F[:, c]) for c in range(self.markers.mesh.dim))

    def hydrodynamic_force(self, state, t, rho: float):
        """Total force the fluid exerts on the body: the negative of the
        imposed forcing integrated over the markers (drag, lift), a
        (dim,) tensor on the solver's device."""
        F = self.marker_forces(state, t)
        return -rho * torch.sum(F * self.markers.ds[:, None], dim=0)
