"""The NS solver object: time loop, monitors, converged reasons.

Counterpart of fluca_tpu.ns.ns (reference fluca/src/ns/interface/
nsbasic.c NSSetUp/NSStep/NSSolve, nsmon.c, nsopts.c). The solver type
registry holds the single implementation "cnlinear", like the
reference.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig, CNLinearSolver
from fluca_tpu_torch.utils import config
from fluca_tpu_torch.utils.options import Options, global_options
from fluca_tpu_torch.utils import profiling
from fluca_tpu_torch.utils.registry import Registry

ns_registry = Registry("ns")
ns_registry.register("cnlinear", CNLinearSolver)


class NSConvergedReason(enum.Enum):
    """Reference: flucans.h:13-19."""

    ITERATING = 0
    CONVERGED_TIME = 1
    CONVERGED_ITS = 2
    DIVERGED_NONLINEAR_SOLVE = -1


def check_device(device) -> torch.device:
    """The device as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class NS:
    """The NS solver object. Its ``state`` is the dict {"v": (u, v),
    "U": (Ux, Uy), "p": p, "phalf": p at the half step} (reference
    fields NS_FIELD_VELOCITY, NS_FIELD_FACE_NORMAL_VELOCITY,
    NS_FIELD_PRESSURE, nsbasic.c:180-182, and the
    pressure-extrapolation state, cnlinear.c:146-153)."""

    def __init__(
        self,
        mesh: CartMesh,
        *,
        device,
        rho: float = 1.0,
        mu: float = 1.0,
        dt: float = 1e-3,
        max_steps: Optional[int] = None,
        max_time: Optional[float] = None,
        ns_type: str = "cnlinear",
        bcs=None,
        options: Optional[Options] = None,
        dtype=None,
        error_if_step_failed: bool = True,
        grid=None,
    ):
        self.mesh = mesh
        self.device = check_device(device)
        self.rho = float(rho)
        self.mu = float(mu)
        self.dt = float(dt)
        self.max_steps = max_steps
        self.max_time = max_time
        self.ns_type = ns_type
        self.bcs = list(bcs) if bcs is not None else [None] * (2 * mesh.dim)
        self.options = options or global_options()
        self.dtype = config.resolve_dtype(dtype)
        self.error_if_step_failed = error_if_step_failed

        self.step_index = 0
        self.t = 0.0
        self.reason = NSConvergedReason.ITERATING
        self.monitors: list[Callable] = []
        # monitor cadence inside advance(): the batch is chunked into
        # runs of this many steps with the monitor chain called between
        # chunks (-ns_monitor_interval). None = monitors run only
        # before/after the whole advance batch.
        self.monitor_interval: Optional[int] = None
        self.last_diag = None
        self.impl: Optional[CNLinearSolver] = None
        self.state = None
        # the device grid the solver is built on (``shard``): a rank-held
        # grid must be known before anything is allocated
        self._grid = grid

    # -- setup ---------------------------------------------------------
    def set_boundary_condition(self, boundary_index: int, bc) -> None:
        """Reference: NSSetBoundaryCondition."""
        self.bcs[int(boundary_index)] = bc

    def set_from_options(self) -> None:
        """Reference: NSSetFromOptions (nsopts.c:167-203)."""
        o = self.options.sub("ns_")
        self.rho = o.get_real("density", self.rho)
        self.mu = o.get_real("viscosity", self.mu)
        self.dt = o.get_real("time_step_size", self.dt)
        if o.has("max_steps"):
            self.max_steps = o.get_int("max_steps")
        if o.has("max_time"):
            self.max_time = o.get_real("max_time")
        self.ns_type = o.get_str("type", self.ns_type)
        self.error_if_step_failed = o.get_bool(
            "error_if_step_failed", self.error_if_step_failed
        )

    def setup(self) -> None:
        """Reference: NSSetUp (nsbasic.c:153-274), the NS_SetUp span
        (the log event of nspkg.c:21-24)."""
        if self.impl is not None:
            return
        if any(b is None for b in self.bcs):
            raise ValueError("all boundary conditions must be set before setup")
        with profiling.span("NS_SetUp"):
            cfg = CNLinearConfig.from_options(self.options)
            factory = ns_registry.get(self.ns_type)
            self.impl = factory(
                self.mesh, self.bcs, self.rho, self.mu, self.dt,
                cfg=cfg, dtype=self.dtype, device=self.device, grid=self._grid,
            )
            if self.state is None:
                self.state = self.impl.zero_state()

    # -- domain decomposition -------------------------------------------
    def shard(self, grid=None, shape=None, devices=None) -> None:
        """Run the solver over a device grid, the counterpart of
        fluca_tpu/ns/ns.py:125-150 (the reference's MPI rank
        decomposition, MeshSetUp_Cart, cart.c:85-151): its kernels run
        sharded, with the edge planes exchanged between shards
        (``CNLinearSolver.set_device_grid``). ``grid`` is a
        parallel.mesh.DeviceGrid or RankGrid; or pass ``shape`` (e.g.
        (2, 4)) and/or ``devices`` to build one (``make_device_grid``, on
        the solver's device by default; under a process group of more than
        one rank, the rank-held grid).

        On a DeviceGrid the shards share the solver's device and the state
        stays where it is. A RankGrid is taken before ``setup`` (or given
        as ``NS(grid=)``, which the ``setup_*`` models pass on): the solver
        and its zero state are then built on this rank's block of ``v``,
        ``U``, ``p`` and ``phalf`` (cells, and faces lo + hilast), and no
        rank allocates a field of the whole grid; ``interop.cut_state``
        cuts a whole state for ``set_solution``, and ``gather_state``
        assembles the whole state for output. ``advance``, ``step`` and the
        monitors run on every rank."""
        from fluca_tpu_torch.parallel.mesh import RankGrid, make_device_grid

        if grid is None:
            grid = make_device_grid(self.mesh.dim,
                                    devices=[self.device] if devices is None else devices,
                                    shape=shape)
        if self.impl is None:
            self._grid = grid
            self.setup()
        elif isinstance(grid, RankGrid):
            raise ValueError("a rank-held grid is taken before setup (NS(grid=), "
                             "setup_*(grid=)), so that no rank builds the whole solver")
        else:
            self.impl.set_device_grid(grid)

    def gather_state(self):
        """The whole state, assembled from every rank's block, on rank 0
        (None on the others); every rank must call it. The state itself
        where no rank-held grid is set. Nothing in the step calls it: it is
        for comparisons and output."""
        if not self.impl.rank_held:
            return self.state
        grid, m = self.impl.grid, self.mesh
        out = {
            "v": tuple(grid.gather(x, m.N, m.periodic) for x in self.state["v"]),
            "U": tuple(grid.gather(x, m.N, m.periodic, face=d)
                       for d, x in enumerate(self.state["U"])),
            "p": grid.gather(self.state["p"], m.N, m.periodic),
            "phalf": grid.gather(self.state["phalf"], m.N, m.periodic),
        }
        return out if grid.rank == 0 else None

    @property
    def device_grid(self):
        return self.impl.grid if self.impl is not None else None

    # -- solution access ----------------------------------------------
    @property
    def solution(self):
        return self.state

    def get_solution_sub(self, field: str):
        """Reference: NSGetSolutionSubVector (nssol.c:44-128)."""
        self.setup()
        return self.state[field]

    def set_solution(self, v=None, U=None, p=None, phalf=None) -> None:
        self.setup()
        if v is not None:
            self.state["v"] = tuple(v)
        if U is not None:
            self.state["U"] = tuple(U)
        if p is not None:
            self.state["p"] = p
        if phalf is not None:
            self.state["phalf"] = phalf

    # -- monitors ------------------------------------------------------
    def add_monitor(self, fn: Callable) -> None:
        """fn(ns) called before each step and after the last
        (reference: NSMonitor chain, nsmon.c:4-45)."""
        self.monitors.append(fn)

    def _monitor(self) -> None:
        for fn in self.monitors:
            fn(self)

    # -- stepping ------------------------------------------------------
    def step(self) -> None:
        """Reference: NSStep (nsbasic.c:276-299), the NS_Step span (the
        root of the step's spans). The converged check is the step's one
        host read where the solves run fixed budgets."""
        self.setup()
        with profiling.span(profiling.ROOT):
            self.state, diag = self.impl.step(
                self.state, self.t, self.step_index
            )
            ok = profiling.read(diag["converged"], "converged", bool)
        self.last_diag = diag
        if not ok:
            self.reason = NSConvergedReason.DIVERGED_NONLINEAR_SOLVE
            if self.error_if_step_failed:
                raise RuntimeError(
                    f"NS step {self.step_index} diverged: "
                    f"rnorm={float(diag['ksp_rnorm'])}"
                )
            return
        self.step_index += 1
        self.t += self.dt

    def advance(self, n: int) -> None:
        """Advance n steps: the first step (if not yet taken) alone,
        then batches with one host read each. When monitors are
        registered and ``monitor_interval`` is set, the batch is
        chunked into interval-sized runs with the monitor chain called
        between chunks (the reference calls monitors every step,
        nsbasic.c:336-345)."""
        self.setup()
        if n <= 0:
            return
        if self.step_index == 0:
            self.step()
            n -= 1
        k = self.monitor_interval if self.monitors else None
        while n > 0:
            if k:
                self._monitor()
            m = min(k, n) if k else n
            self._advance_batch(m)
            if self.reason == NSConvergedReason.DIVERGED_NONLINEAR_SOLVE:
                return
            n -= m

    def _advance_batch(self, n: int) -> None:
        self.state, diag = self.impl.multi_step(self.state, self.t, n)
        self.last_diag = diag
        if not profiling.read(diag["converged"], "converged", bool):
            self.reason = NSConvergedReason.DIVERGED_NONLINEAR_SOLVE
            if self.error_if_step_failed:
                raise RuntimeError(
                    f"NS diverged within steps "
                    f"{self.step_index}..{self.step_index + n}"
                )
            return
        self.step_index += n
        self.t += n * self.dt

    def _check_finished(self) -> bool:
        if self.max_steps is not None and self.step_index >= self.max_steps:
            self.reason = NSConvergedReason.CONVERGED_ITS
            return True
        if self.max_time is not None and self.t >= self.max_time - 1e-12:
            self.reason = NSConvergedReason.CONVERGED_TIME
            return True
        return False

    def solve(self) -> NSConvergedReason:
        """Reference: NSSolve (nsbasic.c:325-351), incl. the
        -ns_view_pre / -ns_view hooks (nsbasic.c:331-349)."""
        self.setup()
        if self.options.sub("ns_").get_bool("view_pre"):
            print(self.view())
        self.reason = NSConvergedReason.ITERATING
        while not self._check_finished():
            self._monitor()
            self.step()
            if self.reason == NSConvergedReason.DIVERGED_NONLINEAR_SOLVE:
                return self.reason
        self._monitor()
        if self.options.sub("ns_").get_bool("view"):
            print(self.view())
        return self.reason

    def view(self) -> str:
        """ASCII view of the solver configuration (reference: NSView
        and per-class ASCII View methods)."""
        lines = [
            f"NS object, type {self.ns_type}",
            f"  mesh: {self.mesh}",
            f"  device: {self.device}, dtype: {self.dtype}",
            f"  density rho = {self.rho:g}, viscosity mu = {self.mu:g}",
            f"  dt = {self.dt:g}, step = {self.step_index}, "
            f"t = {self.t:g}",
            f"  max_steps = {self.max_steps}, max_time = {self.max_time}",
            "  boundary conditions: "
            + ", ".join(
                f"{i}:{b.type.value if b else None}"
                for i, b in enumerate(self.bcs)
            ),
        ]
        if self.impl is not None:
            cfg = self.impl.cfg
            lines.append(
                f"  ksp: {cfg.outer_type} rtol={cfg.rtol:g} "
                f"restart={cfg.restart} maxiter={cfg.maxiter}"
                f" + ABF(schur_ainv={cfg.schur_ainv},"
                f" upper_ainv={cfg.upper_ainv})"
            )
            lines.append(
                f"  schur: {cfg.schur_solver}+mg "
                f"({len(self.impl.mg.levels)} levels)"
                f" rtol={cfg.schur_rtol:g};"
                f" momentum: {cfg.mom_solver}+jacobi rtol={cfg.mom_rtol:g}"
            )
        return "\n".join(lines)
