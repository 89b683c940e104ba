"""Smoke test of fluca_tpu_torch on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase; exits non-zero on any failure
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of 3 steps
                                     # of the 2-D cavity, 3-D cavity, the
                                     # channels (float32 and bf16) and the
                                     # IBM cells

Phases:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the CUDA kernels from fluca_tpu_torch/csrc, one nvcc
     process per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card,
     float32 and float64: the 2-D Poisson modes on every multigrid level of
     the 256^2 and 1024^2 cavities (wall and periodic), the 2-D momentum
     kernel on the planes of real cavity and Taylor-Green steps; the 3-D
     Poisson modes on every level of the 64x64x32 cavity and the stretched
     128^3 channel, the 3-D momentum kernel on the factors of real cavity
     and channel steps and on random factors with PRESSURE_OUTLET and
     SYMMETRY boundaries; and each kernel's bf16 instance against its bf16
     plain version: the Poisson modes on every level of the 256^2 cavity's
     bf16 hierarchy, the 2-D momentum kernel on real cavity and Taylor-Green
     planes cast to bf16 (the 3-D bf16 checks run in phases 7 and 8); the
     three stages of the chain kernel (coupled, ABF pre, ABF post) against
     chain3d_plain, float32 and float64, at 16^3 and 37x29x33 with every
     lo/hi BC pair, and on the bands of every 3-D solver the script builds,
     before it runs;
  4. time: device time (CUDA graph) and eager time of each kernel and its
     plain version, with its bound, float32 and bf16: 2-D at 256^2 and
     4096^2 (the 4096^2 times and launch plans also in the kernels line),
     3-D at 128^3; the chain's stages also beside the unfused
     sequence of banded operators they replace (and at 512x256x256 in 8);
     the momentum 3-D halo instance on a (2, 2, 2) grid of the 128^3
     channel (held against its plain version and the unsharded kernel
     first);
  5. slice 2-D: the 256^2 Re 100 lid-driven cavity with the fixed-budget
     production solver, one step and advance(20), with the 2-D kernels'
     launch counts; then 5 steps against the plain float64 run on the CPU;
     the same with the bf16 preconditioner on both inner solves; and
     fluca_tpu's own accuracy pin of the bf16 preconditioner (the 128^2
     cavity, 50 steps, against the converged solve); and the two bf16
     inner solves of its preconditioner against the exact solution;
  6. app 2-D: the CLI entry point with the reference's FGMRES rtol 1e-5
     solver;
  7. slice 3-D: the 64x64x32 cavity (SYMMETRY back plane), step and
     advance(20), with the 3-D kernels' launch counts, and the 128^3
     channel (its residual and mean-flow retention printed, not gated,
     as bench.py does), production, in float32 and with the bf16
     preconditioner on both inner solves (bench.py:385-392); the 3-D bf16
     instances against their plain versions on the bf16 run's multigrid
     levels and step factors; 5 cavity steps against the plain float64
     run on the CPU; every 3-D run goes through the chain kernel;
  7b. chain A/B: the step chained against unchained (the banded
     operators), float64: the 128^3 channel's first step, within the
     unchained step's own distance from a run one rounding away; 11 steps
     of the 64^3 channel within AB64_MAX; a planted fault (one band row
     zeroed) must exceed both bounds;
  8. channel 512: the wall-clustered 512x256x256 channel (BASELINE config
     #5) at full size, 92 steps, gated as bench.py gates it: finite fields,
     mean-flow retention >= 0.9 after 11 steps, ksp_rnorm <= 500 over
     steps 73-92 (steps/s over those 20); then the 3-D kernels against
     their plain versions at its shapes (the Poisson modes on every
     multigrid level, the momentum kernel on the step's factors; float32
     and float64) and their times at 512x256x256. First in float32 with
     production(3, 8, 6); then with the solver fluca_tpu ships for this
     channel (bench.py:450-454: production(2, 6, 8), Jacobi momentum, the
     bf16 preconditioner on the momentum solve), under the same gates, with
     the bf16 instances checked and timed at its shapes;
  9. app 3-D: the CLI entry point at 64^3 with -cart_dim 3;
  9b. ibm: the immersed-boundary wakes through the port's checkpoint
     loader, the step's kernels on their shapes and band sets (inflow,
     PRESSURE_OUTLET, SYMMETRY) held against their plain versions first:
     BASELINE #3, the 176x88 cylinder at Re 100 from the committed
     checkpoint at t = 30, 64 x advance(5), St within 5 % of 0.164 and the
     C_L amplitude in (0.1, 0.4); BASELINE #4 at its CI size, the 48x32x32
     sphere from t = 25.02, advance(25), C_D drift < 5e-3 and within 2 % of
     1.4680; both in float64 and float32; the 512x64 backward-facing step
     (float64 and float32, from rest): a step and advance(20), the inlet
     profile, the inlet's mass flux at the outlet within 1e-6, float32
     against float64; the 128^3 sphere (float32, from
     uniform flow): a step and advance(20), finite, steps/s and peak
     memory, and its checkpoint restart at max abs 0; the float32 cylinder
     restarted mid-run and run twice, at max abs 0; two planted faults (a
     checkpoint byte flipped, one marker's spread weight zeroed) that must
     be caught; the benchmark's 4096x2048 cylinder (float32, from uniform
     flow): the 2-D kernels on every level and mode and on the step's
     coefficients, then one step, so that the ledger holds every key its
     cell launches;
 9c. tolerance: the reference's stopping rule (FGMRES rtol 1e-5 on the
     unpreconditioned residual) on tolerance.py's first row, the 128^3
     wall-clustered channel at dt 2e-3, float32: 3 steps cold and 3
     warm-started, every step converged with ksp_rnorm <= 1e-5 ||rhs||,
     the outer iterations and seconds per step printed; then one
     production() step, its effective rtol printed beside the reference's
     TPU record;
 9d. turb: the 64^3 Re_tau 180 channel from the rolls, dt 4e-4, float32
     production(), 200 steps through examples/channel_turb's loop; no
     guard may trip, E_turb and u_tau finite, turb_stats printed;
 9e. fd: the FD tutorials ex1-ex4 on the card in float64 and float32
     against the CPU's float64 runs, and the 3-D Laplacian of the FD
     layer at 256^3 in float32 against its CPU float64 apply;
 10. sharded: the domain-decomposed step (parallel/, NS.shard,
     -parallel_grid), shards as boxes of the global tensors on the card:
     each halo instance (float32 and float64) against its plain version
     and, at max abs difference 0, against the unsharded kernel on the
     global field, on every periodic/wall combination of the reference's
     tests and at the shapes of the runs below; the 256^2 Re 100 cavity on
     a (4, 2) grid (21 steps) and BASELINE #5, the 512x256x256 channel, f32
     production(3, 8, 6) on (2, 2, 2) (11 steps, under its retention gate),
     each against the unsharded unchained run of the same steps
     (SHARDED_RTOL); two planted edge-plane faults that both comparisons
     must catch; the apps with -parallel_grid 2x2 (64^2) and 2x2x2 (32^3);
     the halo instances timed beside the unsharded kernels;
 10b. ranks: the multi-process step (parallel/distributed.py, RankGrid),
     one block per torch.distributed rank, each rank a child process of
     this script (--rank) on the one card under gloo, its edge planes
     staged through pinned host buffers; the parent builds the kernels
     first and the ranks only load them; each rank builds its solver and
     state on its block from the start (NS(grid=)). RANK_CASES: the 256^2
     cavity on (4, 2) (8 ranks, 6 steps, production()) in f64 against the
     one-process run of the same steps (SHARDED_RTOL) and in f32 within
     SPREAD_FACTOR x that run's distance from itself with its dots summed
     over 8 row blocks; the 64^3 channel on (2, 2, 2) (8 ranks, 4 steps,
     f64 production()) at SHARDED_RTOL; BASELINE #5 on (2, 1, 1) (f32
     production(3, 8, 6)): its first step within SPREAD_FACTOR x the
     one-process step's one-rounding spread, 3 steps under the retention
     gate. Every rank holds its kernel calls against the
     one-card sharded calls on the gathered fields (max abs 0) and their
     plain versions, and sends back its launches and ledger keys, merged
     into the ledger; a planted edge-plane fault on every rank must be
     caught; steps/s, exchange ms and bytes per step and peak memory per
     rank (building and stepping) are printed beside the one-process
     run's. Per-rank I/O (RANK_CASES' ``io``): the f64 cavity's ranks save
     a "sharded" checkpoint after 3 steps, fresh rank-held solvers load it
     shard-locally (each rank reads its block's bytes only) and run to 6
     steps, equal to the uninterrupted run at max abs 0; one process loads
     the same checkpoint, equal to rank 0's gather_state() at max abs 0;
     planted faults (a manifest that lost a record, a checkpoint of
     another grid) must be refused; BASELINE #5 saves after its steps and
     reloads on the ranks at max abs 0, with the save's and the load's
     seconds and GB/s per rank and the card's peak memory during the load
     (no more than the stepping peak, and no more than RELOAD_ADDED_MAX x
     the rank's block state above what it held); the hyperslab CGNS writer runs
     where the host has h5py (the card's has none: it is held on the CPU);
 10c. launch: the entry points under ``python -m torch.distributed.run
     --standalone`` (gloo, 2 ranks sharing the card), in one launch whose
     ranks run this script with ``--launched``: each runs the app, then
     bench_scaling, then ici_bytes as ``python -m`` runs them, then holds
     every kernel call of the solvers they built against its plain
     version (and a rank-held one against the one-card sharded calls) and
     writes its launch ledger, merged into the parent's for phase_ledger.
     The app on the 64^2 cavity over 2x1 ranks with -checkpoint (one
     done: line; its checkpoint, loaded by one process, within
     SPREAD_FACTOR x the one-process app run's distance from itself with
     its dots over 8 row blocks), bench_scaling over 2 ranks and in one
     process (--shards 4), ici_bytes over 2x1 ranks, their records
     printed;
 11. probes: the bench and probe entry points (fluca_tpu_torch/bench.py,
     fluca_tpu_torch/examples/) and their kernels (ops/probes.py,
     csrc/probes.cu): copy_scale and copy_rolls against their plain
     versions at max abs 0 at every shape and rows per block the path
     launches, the three poisson3d_variant modes at 512x256x256 (launched
     with the poisson3d apply's plan) at max abs 0, "rebuilt" with true
     edges against the poisson3d apply at max abs 0, and the
     stencils at the path's own shapes; then, counts at 0, the path:
     bench.spmv_roofline (4096^2), bench.poisson3d_roofline (256^3),
     bench.sharded_1x1_ratio (gated at 1.15), probe512, probe512split,
     probe_poisson512 at 512x256x256 and profile512 at 128^3; then each
     probe kernel timed beside its plain version and its bound, the copy
     also against torch.mul on the same buffer in turns (torch.mul,
     copy_scale, copy_scale, torch.mul) at every shape of the path, the
     variants also beside the poisson3d apply and the copy;
 12. resources: the registers, spills, stack and static shared memory of
     the Poisson and momentum kernels (2-D and 3-D, their bf16 and halo
     instances), the chain and the copy kernels, from a separate nvcc
     -Xptxas -v compile of their sources run beside the build and
     finished before the first check (the build's own flags unchanged);
 13. ledger: every kernel wrapper records the (shape, instance, band set)
     keys it launched at, and each check the key it covered; the script
     fails if any launched key went unchecked.
It prints the kernels' JSON summary, then the card's name and power limit
as nvidia-smi gives them, and last {"ok": true, "device": ...}.

Imports nothing of JAX: the card's machine has none.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import itertools
import json
import re
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from fluca_tpu_torch import app, bench
from fluca_tpu_torch.examples import (
    channel_turb, probe512, probe512split, probe_poisson512, profile512,
)
from fluca_tpu_torch.examples.cylinder_strouhal import strouhal
from fluca_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from fluca_tpu_torch.mesh.cart import CartMesh
from fluca_tpu_torch.models.bfs import reattachment_length, setup_bfs_2d
from fluca_tpu_torch.models.cavity import setup_cavity_2d, setup_cavity_3d
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.models.cylinder import drag_lift_coefficients, setup_cylinder_2d
from fluca_tpu_torch.models.sphere import drag_coefficient, setup_sphere_3d
from fluca_tpu_torch.models.tgv import setup_taylor_green_2d
from fluca_tpu_torch.ns import tables as T_
from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig, UnfusedChain
from fluca_tpu_torch.ns.operators import NSOperators
from fluca_tpu_torch.ops import cuda_stencil, probes
from fluca_tpu_torch.ops import fd as fd_ops
from fluca_tpu_torch.ops.chain3d import (
    CHAIN_ROWS, Chain3D, bands_fingerprint, build_chain_bands, chain3d_plain,
)
from fluca_tpu_torch.parallel.mesh import make_device_grid
from fluca_tpu_torch.parallel.sharded import (
    build_momentum2d_sharded, build_momentum_sharded, build_poisson_sharded, field_edges,
    halo_layout,
)
from fluca_tpu_torch.solvers import mg as mg_mod
from fluca_tpu_torch.tutorials import fd as fd_tutorials

# Kernel vs plain version, as ||kernel - plain||_2 / ||plain||_2. Each
# output is a sum of 6 (Poisson) to 14 (momentum) products taken in
# another order, with fused multiply-adds, than the plain version's:
# a few units of roundoff per element, ~1e-7 (f32) and ~1e-16 (f64).
# The bounds leave a factor of ~100; a wrong coefficient, offset or
# boundary read gives O(1e-2) or more.
# A bf16 instance against its bf16 plain version: both sum in float32
# and round once, at the store. Summed in another order they would differ
# only where the two float32 results straddle a bf16 rounding point, by
# a unit there: a norm-relative error of 1e-5 to 1e-4. The bound is bf16's
# unit roundoff, 2^-8 = 3.9e-3; a wrong coefficient, offset or a float32
# plane read as bf16 gives O(1e-2) or more. Every bf16 instance now sums
# in its plain version's order and is also held at max abs 0
# (EXACT_KERNELS), after this bound.
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13, torch.bfloat16: 4e-3}
BF16 = torch.bfloat16
# The kernel instances that must equal their plain versions at max abs
# difference 0, by kernel name and field dtype, at every key they launch
# at. The 2-D Poisson kernel rounds every product and sum on its own in
# the plain version's order (csrc/poisson2d.cu sp_of), in every instance,
# unsharded and halo: a fused order parts its bf16 instance from the plain
# version by a unit at up to a fifth of the cells of the 128^2 pin's Schur
# applies, and the pin's runs on the card from those on the CPU
# (examples/pin128_inner.py). The bf16 instances of the 3-D Poisson and
# momentum kernels round so too (stencil_common.cuh kPlainOrder): summed
# with fused multiply-adds they parted from their plain versions at 495
# and 30 cells of a 32^3 channel step's recorded calls, by up to 844 and 2
# bf16 units. The 2-D momentum kernel's bf16 instance equals its plain
# version with its fused sums: the products of two bf16 values are exact
# in float32, so each fused multiply-add rounds as the plain version's
# sum does (0 cells of 1,572,864 in the pin's recorded calls).
EXACT_KERNELS = {"poisson2d": (torch.float32, torch.float64, BF16),
                 "poisson2d_halo": (torch.float32, torch.float64),
                 "poisson3d": (BF16,), "momentum3d": (BF16,), "momentum2d": (BF16,)}
DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64", BF16: "bf16"}
# 5 fixed-budget cavity steps at 256^2, float32 on the card vs float64
# on the CPU, as ||a - b||_2 / ||b||_2. The same comparison on the CPU
# (float32 vs float64) gives 4e-5 for v and 1.8e-4 for p; the card sums
# in another order, so the bounds leave a factor of 25. A defect in a
# kernel or an operator gives O(1e-2) or more.
SLICE_RTOL = {"v": 1e-3, "p": 5e-3}
# 5 fixed-budget 64x64x32 cavity steps, float32 on the card vs float64 on
# the CPU, as the relative norm over the velocity vector and over p. The
# same comparison on the CPU (float32 vs float64) gives 2.0e-7 for v and
# 1.2e-6 for p; the bounds leave a factor of 25, as SLICE_RTOL does.
SLICE3D_RTOL = {"v": 5e-6, "p": 3e-5}
# 5 fixed-budget 256^2 cavity steps with the bf16 preconditioner (float32
# solver, card) vs the plain float64 run without it (CPU), as SLICE_RTOL.
# On the momentum solve alone it gives 3.6e-2 (v) and 4.0e-2 (p) on the
# CPU, 4.1e-2 and 2.9e-2 on the card; the bounds leave a factor of 5. On
# both inner solves the comparison is printed and is no check: the
# impulsive start at CFL 2.56 is not resolved by the production budget in
# any precision (step 1 ends at ksp_rnorm 26 in float64), and with bf16 on
# both inner solves the startup swing does not die out (phase_slice_bf16),
# in fluca_tpu's own code too (tests/test_torch_bf16_witness.py): 0.82 and
# 0.10 on the CPU, 0.50 and 0.46 on the card. The bf16 accuracy gates are
# BUDGET_MAX_DEV and INNER_BF16_MAX.
SLICE_BF16_RTOL = {"v": 0.2, "p": 0.2}
# The two bf16 inner solves on the card, against the exact float64
# solution on the CPU, as ||x - exact|| / ||exact||, on the inputs of
# tests/test_torch_bf16_witness.py (the 128^2 cavity at dt 0.005): the
# Schur solve (6 CG iterations over the bf16 multigrid, with the
# projection) on a random and a smooth rhs, and the momentum solve (8
# BiCGStab iterations) at a random state. fluca_tpu's own bf16 solves, run
# op by op on the CPU, give 1.0e-2, 1.9e-2 and 6.9e-3 there, the port's
# 5.3e-3, 2.9e-3 and 5.3e-3; the bounds are 1.5x fluca_tpu's readings, as
# that test holds the port on the CPU. A wrong coefficient, projection or
# coarse solve gives O(1e-1) or more.
INNER_BF16_MAX = {"schur random": 1.5e-2, "schur smooth": 2.8e-2, "momentum": 1.0e-2}
# fluca_tpu's accuracy pin of the bf16 preconditioner
# (examples/tune_budget_tpu.py): the 128^2 cavity, dt 0.005, 50 float32
# steps, max |deviation| over u, v and p from the converged FGMRES rtol
# 1e-5 solve. float32 production is held to the repo's production pin,
# 2e-4 U_lid (tests/test_fastpath.py); the bf16 preconditioner (both) to
# 5e-2 U_lid. fluca_tpu measured 1.31e-4 and 9.36e-3 on its TPU
# (TUNE_BUDGET_TPU.json), where XLA fuses several operations into one
# rounding; its own code run op by op on the CPU gives 2.03e-2, the port
# 1.5e-2 to 2.3e-2 on the CPU (by thread count; tests/
# test_torch_bf16_witness.py pin) and 2.21e-2 on the H100, where it read
# 2.96e-2 while poisson2d summed with fused multiply-adds (EXACT_KERNELS).
BUDGET_MAX_DEV = {"f32": 2e-4, "bf16": 5e-2}
# The step chained (Chain3D) against unchained (the banded operators), in
# float64, as ||a - b|| / ||b|| over v, over U and over p without its
# volume-weighted mean (phase_chain_ab). The 128^3 channel's first
# production step (ksp_rnorm ~2000) is chaotic, so its bound is the
# unchained step's own distance from a run whose initial v is moved by
# one rounding, read in the same call. On the H100 chaining moved the step
# by 2.9e-6 (v), 2.4e-6 (U) and 7.4e-5 (p), 0.06-0.07 of that distance
# (4.3e-5, 3.5e-5, 1.2e-3), the planted fault by 9.4e-3, 8.8e-3 and 1.14.
# On the CPU (tests/test_torch_chain3d.py sensitivity, 4 torch threads)
# the ratio is 4.4-5.2 in another summation order: the gate is the card's.
# 11 production steps of the 64^3 channel are not chaotic: 1.3e-8 (v),
# 1.1e-8 (U) and 7.3e-7 (p) on the CPU (tests/test_torch_chain3d.py ab64),
# the planted fault 0.12, 0.094 and 35; on the H100 6.6e-9, 5.3e-9 and
# 3.1e-7, the fault the same. The bounds leave a factor 75-330 above the
# readings.
AB64_MAX = {"v": 1e-6, "U": 1e-6, "p": 1e-4}
# The BASELINE #5 channel's solve-quality gates (bench.py:52-53, 474-480).
RETENTION_MIN = 0.9
RNORM_MAX = 500.0
# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# H100 SXM's 3.35 TB/s and its float32 operations over its 67 TFLOP/s
# outside the tensor cores (NVIDIA's data sheet). The bf16 instances
# compute in float32 too.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations per cell, counted from the kernels' source: Poisson
# 2-D (6 + 6 + 1 for Sp, then b - Sp and p + omega w (b - Sp)), Poisson
# 3-D (15 for the three axis sums, 7 to combine them), momentum 2-D (13
# products and 12 sums per component), momentum 3-D (per axis 10 for the
# normal sums, 11 for c == a and 24 for each c != a; the +-2 boundary rows
# are left out: they act on the boundary cells only)
FLOPS_PER_CELL = {
    "poisson2d": {"apply": 13, "residual": 14, "smooth": 17},
    "poisson3d": {"apply": 22, "residual": 23, "smooth": 26},
    "momentum2d": 50,
    "momentum3d": 207,
}


def nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def coeff_tensors(c):
    """The arrays of a Poisson coefficient set."""
    return [getattr(c, k) for k in ("rx", "ry", "cy", "cyb", "a0", "c1", "c2",
                                    "h0", "h1", "h2") if hasattr(c, k)]


def bound(nbytes_moved, flops):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, iters=200, warmup=10) -> float:
    """Mean time of one eager fn() call in ms, by CUDA events around
    ``iters`` back-to-back calls. Where the host takes longer to issue a
    call than the device takes to run it, this is the host's time per
    call, which is what the eager main path pays."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=50, replays=20) -> float:
    """Device time of one fn() call in ms: ``calls`` calls captured in
    a CUDA graph, replayed ``replays`` times between CUDA events, so
    no host time is counted."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def assert_finite(ns, what):
    st = ns.state
    for name, leaf in (*((f"v{c}", x) for c, x in enumerate(st["v"])),
                       *((f"U{d}", x) for d, x in enumerate(st["U"])),
                       ("p", st["p"]), ("phalf", st["phalf"])):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"non-finite {name} in {what}")


def launch_counts():
    """Launches since the last reset, by instance: "poisson2d" for the
    float32 one, "poisson2d_bf16" for the bf16 one, and so on."""
    out = {}
    for k in cuda_stencil.KERNELS:
        out[k.name] = k.launches_by_dtype["f32"]
        out[f"{k.name}_bf16"] = k.launches_by_dtype["bf16"]
    return out


def timed_run(ns, n):
    """One step, then advance(n), between synchronisations; returns
    (first-step s, advance s, launches by instance)."""
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    ns.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ns.advance(n)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, launch_counts()


def require_launches(launches, names, what):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by {what}")


def per_step(launches, steps):
    """The launched instances' counts per step."""
    return {k: round(v / steps, 2) for k, v in launches.items() if v}


def cavity_bcs():
    wall = zero_velocity_bc()
    lid = BoundaryCondition(
        BCType.VELOCITY, velocity=lambda t, xs: (1.0 + 0.0 * xs[0], 0.0 * xs[0])
    )
    return [wall, wall, wall, lid]


def unit_mesh(N, periodic):
    m = CartMesh.create((N, N), (periodic, periodic))
    m.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    return m


def bcs_for(periodic):
    return [BoundaryCondition(BCType.PERIODIC)] * 4 if periodic else cavity_bcs()


# ----------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = cuda_stencil.build_library()
    cuda_stencil.load_library()
    print(f"[build] {lib} in {time.perf_counter() - t0:.2f} s", flush=True)


# The sources whose kernels' registers, spills and shared memory the run
# reports, each compiled once more with -Xptxas -v (the production build's
# flags are not changed); and the kernels of each, by their mangled names.
RESOURCE_SOURCES = ("poisson2d.cu", "momentum2d.cu", "momentum3d.cu", "poisson3d.cu",
                    "chain3d.cu", "probes.cu")
# poisson2d_kernel<T, MODE, HALO, VEC, ONE> (ONE false: runs of more than
# one row) and momentum2d_kernel<T, HALO, VEC> at the cells per lane their
# plans take at 4096^2
_P2, _M2 = cuda_stencil.POISSON2D_VEC, cuda_stencil.MOMENTUM2D_VEC
RESOURCE_KERNELS = {
    "poisson2d": rf"poisson2d_kernelIfLi0ELb0ELi{_P2[torch.float32]}ELb0E",
    "poisson2d residual": rf"poisson2d_kernelIfLi1ELb0ELi{_P2[torch.float32]}ELb0E",
    "poisson2d smooth": rf"poisson2d_kernelIfLi2ELb0ELi{_P2[torch.float32]}ELb0E",
    "poisson2d_bf16": rf"poisson2d_kernelI13__nv_bfloat16Li0ELb0ELi{_P2[torch.bfloat16]}ELb0E",
    "poisson2d_bf16 smooth": rf"poisson2d_kernelI13__nv_bfloat16Li2ELb0ELi{_P2[torch.bfloat16]}ELb0E",
    "poisson2d (f64)": rf"poisson2d_kernelIdLi0ELb0ELi{_P2[torch.float64]}ELb0E",
    "poisson2d_halo": rf"poisson2d_kernelIfLi0ELb1ELi{_P2[torch.float32]}ELb0E",
    "poisson2d_halo smooth": rf"poisson2d_kernelIfLi2ELb1ELi{_P2[torch.float32]}ELb0E",
    "poisson2d_halo (f64)": rf"poisson2d_kernelIdLi0ELb1ELi{_P2[torch.float64]}ELb0E",
    "momentum2d": rf"momentum2d_kernelIfLb0ELi{_M2[torch.float32]}E",
    "momentum2d_bf16": rf"momentum2d_kernelI13__nv_bfloat16Lb0ELi{_M2[torch.bfloat16]}E",
    "momentum2d (f64)": rf"momentum2d_kernelIdLb0ELi{_M2[torch.float64]}E",
    "momentum2d_halo": rf"momentum2d_kernelIfLb1ELi{_M2[torch.float32]}E",
    "momentum2d_halo (f64)": rf"momentum2d_kernelIdLb1ELi{_M2[torch.float64]}E",
    "momentum3d": r"momentum3d_kernelIfLb0E", "momentum3d_bf16": r"momentum3d_kernelI13__nv_bfloat16Lb0E",
    "momentum3d (f64)": r"momentum3d_kernelIdLb0E", "momentum3d_halo": r"momentum3d_kernelIfLb1E",
    "momentum3d_halo (f64)": r"momentum3d_kernelIdLb1E",
    # poisson3d_kernel<T, MODE, HALO, STRIP> (poisson3d.cuh): poisson3d.cu's
    # instances (STRIP kNone, -1), the apply in the entries, the other
    # modes printed beside it; probes.cu's variants (STRIP 0, 1, 2)
    "poisson3d": r"poisson3d_kernelIfLi0ELb0ELin1E",
    "poisson3d residual": r"poisson3d_kernelIfLi1ELb0ELin1E",
    "poisson3d smooth": r"poisson3d_kernelIfLi2ELb0ELin1E",
    "poisson3d_bf16": r"poisson3d_kernelI13__nv_bfloat16Li0ELb0ELin1E",
    "poisson3d_bf16 smooth": r"poisson3d_kernelI13__nv_bfloat16Li2ELb0ELin1E",
    "poisson3d (f64)": r"poisson3d_kernelIdLi0ELb0ELin1E",
    "poisson3d_halo": r"poisson3d_kernelIfLi0ELb1ELin1E",
    "poisson3d_halo smooth": r"poisson3d_kernelIfLi2ELb1ELin1E",
    "poisson3d_halo (f64)": r"poisson3d_kernelIdLi0ELb1ELin1E",
    "poisson3d_variant": r"poisson3d_kernelIfLi0ELb0ELi0E",
    "poisson3d_variant noroll": r"poisson3d_kernelIfLi0ELb0ELi1E",
    "poisson3d_variant nocomp": r"poisson3d_kernelIfLi0ELb0ELi2E",
    # chain3d_kernel<T, STAGE>
    "chain3d_coupled": r"chain3d_kernelIfLi0E", "chain3d_pre": r"chain3d_kernelIfLi1E",
    "chain3d_post": r"chain3d_kernelIfLi2E", "chain3d_coupled (f64)": r"chain3d_kernelIdLi0E",
    "chain3d_pre (f64)": r"chain3d_kernelIdLi1E", "chain3d_post (f64)": r"chain3d_kernelIdLi2E",
    "copy_scale": r"copy_scale_kernelILi4ELi4E",
    "copy_scale (float4, 2 rows in flight)": r"copy_scale_kernelILi4ELi2E",
}


def start_resource_report():
    """Start the -Xptxas -v compiles of RESOURCE_SOURCES, one process
    each, into the build directory; they run beside the build."""
    out = cuda_stencil.build_dir() / "resources"
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen([cuda_stencil._nvcc(), *cuda_stencil.NVCC_FLAGS, "-Xptxas", "-v",
                              "-I", str(cuda_stencil.CSRC_DIR), "-c", "-o", str(out / f"{src}.o"),
                              str(cuda_stencil.CSRC_DIR / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in RESOURCE_SOURCES]


def finish_resource_report(procs):
    """Wait for the compiles; print each RESOURCE_KERNELS kernel's
    registers, spill bytes, stack and static shared memory from ptxas
    (its dynamic shared memory is the launch plan's), and return its
    registers and spill bytes by label, for the kernels line."""
    text = ""
    for p in procs:
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{out}")
        text += out
    by_name, usage = {}, {}
    for name, body in re.findall(r"Compiling entry function '(\S+)' for '\w+'\n(.*?)(?=ptxas info\s+: Compiling|\Z)",
                                 text, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          body)
        smem = re.search(r"(\d+) bytes smem", body)
        by_name[name] = (int(regs.group(1)), *(int(x) for x in spill.groups()),
                         int(smem.group(1)) if smem else 0)
    for label, pattern in RESOURCE_KERNELS.items():
        found = [u for name, u in by_name.items() if re.search(pattern, name)]
        if len(found) != 1:
            raise AssertionError(f"ptxas reported {len(found)} kernels for {label}")
        regs, stack, spill_st, spill_ld, smem = found[0]
        print(f"[resources] {label}: {regs} registers, {spill_st} bytes spill stores, "
              f"{spill_ld} bytes spill loads, {stack} bytes stack, {smem} bytes static shared "
              f"memory", flush=True)
        usage[label] = {"registers": regs, "spill_bytes": spill_st + spill_ld}
    return usage


def step_v0f(ops, state, t):
    """v0f = B v0 + bcB(t), as the step forms it."""
    Bv0 = ops.apply_B(state["v"])
    bcB = ops.bc_B(t)
    return tuple(tuple(Bv0[d][c] + bcB[d][c] for c in range(ops.dim))
                 for d in range(ops.dim))


def check_kernel(results, label, dtype, got, ref, kernel):
    """Hold the outputs ``got`` of ``kernel``'s last launch against its
    plain version's ``ref``; record the launch's key as checked in the
    kernel's ledger."""
    for g, r in zip(got, ref):
        err = rel_err(g, r)
        if not err <= KERNEL_RTOL[dtype]:
            raise AssertionError(f"{label} {dtype}: rel err {err:.3e} > "
                                 f"{KERNEL_RTOL[dtype]:g}")
        if dtype in EXACT_KERNELS.get(kernel.name, ()) and max_abs(g, r) != 0.0:
            raise AssertionError(f"{label} {dtype}: max abs {max_abs(g, r):.3e} against "
                                 f"the plain version, which it must equal bit for bit")
        results["max_abs_err"] = max(results["max_abs_err"], max_abs(g, r))
        results["max_rel_err"][dtype] = max(results["max_rel_err"][dtype], err)
    kernel.mark_checked()


def report(name, n_checks, results):
    errs = " ".join(f"{e:.3e} ({DTYPE_NAMES[d]})"
                    for d, e in results["max_rel_err"].items())
    print(f"[kernels] {name}: {n_checks} checks passed, max abs err "
          f"{results['max_abs_err']:.3e}, max rel err {errs}", flush=True)


def check_poisson(results):
    """Every mode, both dtypes, wall and periodic, on every multigrid
    level of the 256^2 and 1024^2 cavities."""
    rng = np.random.default_rng(0)
    n_checks = 0
    for dtype in (torch.float32, torch.float64):
        for periodic in (False, True):
            for N in (256, 1024):
                mg = mg_mod.PoissonMG(unit_mesh(N, periodic), bcs_for(periodic),
                                      scale=0.01, dtype=dtype, device="cuda")
                for lvl in mg.levels:
                    shape = lvl.mesh.cell_shape
                    p, b = (torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                            device="cuda") for _ in range(2))
                    for mode in cuda_stencil.POISSON_MODES:
                        args = {"apply": (), "residual": (b,),
                                "smooth": (b, lvl.inv_diag, 0.8)}[mode]
                        got = cuda_stencil.poisson2d(mode, p, lvl.coeffs, *args)
                        ref = cuda_stencil.poisson2d_plain(mode, p, lvl.coeffs, *args)
                        torch.cuda.synchronize()
                        check_kernel(results, f"poisson2d {mode} periodic={periodic} "
                                     f"{shape}", dtype, (got,), (ref,),
                                     cuda_stencil.poisson2d)
                        n_checks += 1
    report("poisson2d", n_checks, results)


def check_poisson_bf16(results):
    """Every mode of the bf16 instance on every level of the 256^2
    cavity's bf16 hierarchy (bf16 fields, float32 coefficients)."""
    rng = np.random.default_rng(10)
    mg = mg_mod.PoissonMG(unit_mesh(256, False), cavity_bcs(), scale=0.01,
                          dtype=BF16, device="cuda")
    n_checks = sum(check_poisson_modes(results, "cavity 256^2", rng, lvl.coeffs,
                                       lvl.inv_diag) for lvl in mg.levels)
    report("poisson2d_bf16", n_checks, results)


def momentum_cases(dtype):
    """(name, ops, W) from real steps: the cavity after 2 steps (wall
    boundaries) and the Taylor-Green vortex (periodic)."""
    cav = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda", dtype=dtype)
    cav.impl.cfg = CNLinearConfig.production()
    cav.advance(2)
    tgv = setup_taylor_green_2d(N=256, nsteps=10, t_final=0.1, periodic=True,
                                device="cuda", dtype=dtype)
    out = []
    for name, ns in (("cavity", cav), ("tgv-periodic", tgv)):
        ops = ns.impl.ops
        v0f = step_v0f(ops, ns.state, ns.t)
        out.append((name, ops, ops.build_momentum_coeffs_stacked(ns.state["U"], v0f)))
    return out


def check_momentum(results):
    rng = np.random.default_rng(1)
    n_checks = 0
    for dtype in (torch.float32, torch.float64):
        for name, ops, W in momentum_cases(dtype):
            u, v = (torch.as_tensor(rng.standard_normal(ops.mesh.cell_shape),
                                    dtype=dtype, device="cuda") for _ in range(2))
            got = cuda_stencil.momentum2d(W, u, v, ops.mesh.periodic)
            ref = cuda_stencil.momentum2d_plain(W, u, v, ops.mesh.periodic)
            torch.cuda.synchronize()
            check_kernel(results, f"momentum2d {name}", dtype, got, ref,
                         cuda_stencil.momentum2d)
            n_checks += 1
    report("momentum2d", n_checks, results)


def check_momentum_bf16(results):
    """The bf16 instance on the planes of real float32 cavity and
    Taylor-Green steps cast to bf16, as the step casts them."""
    rng = np.random.default_rng(11)
    n_checks = 0
    for name, ops, W in momentum_cases(torch.float32):
        u, v = (torch.as_tensor(rng.standard_normal(ops.mesh.cell_shape), dtype=BF16,
                                device="cuda") for _ in range(2))
        W16 = W.to(BF16)
        got = cuda_stencil.momentum2d(W16, u, v, ops.mesh.periodic)
        ref = cuda_stencil.momentum2d_plain(W16, u, v, ops.mesh.periodic)
        torch.cuda.synchronize()
        check_kernel(results, f"momentum2d {name}", BF16, got, ref,
                     cuda_stencil.momentum2d)
        n_checks += 1
    report("momentum2d_bf16", n_checks, results)


def time_one(label, kernel, plain, nbytes_moved, flops, calls=50, replays=20,
             iters=200):
    """Device time (CUDA graph of ``calls`` launches) and eager time per
    call of a kernel and its plain version, beside the bound of the
    kernel's work; returns the device times and the bound."""
    ms = graph_ms(kernel, calls, replays)
    plain_ms = graph_ms(plain, calls, replays)
    eager, plain_eager = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    bound_ms, bound_by = bound(nbytes_moved, flops)
    print(f"[time] {label}: kernel {ms:.5f} ms on the device "
          f"({nbytes_moved / ms / 1e6:.1f} GB/s moved; bound {bound_ms:.5f} ms by "
          f"{bound_by}, {100 * bound_ms / ms:.1f} % of the kernel's time), "
          f"{eager:.5f} ms per eager call; plain {plain_ms:.5f} ms on the "
          f"device, {plain_eager:.5f} ms per eager call", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def time_kernels(entries):
    """The 2-D kernels, float32 and bf16: Poisson at 256^2 and 4096^2,
    momentum on real cavity planes at 256^2 and random planes at 4096^2.
    The 256^2 apply and momentum times go to ``entries``, the 4096^2 ones
    (every Poisson mode) with their launch plans to its ``at_4096``."""
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    (name, ops, W), _ = momentum_cases(torch.float32)
    per = ops.mesh.periodic
    for dtype in (torch.float32, BF16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        dname = DTYPE_NAMES[dtype]
        for N in (256, 4096):
            mesh = unit_mesh(N, False)
            axbcs = T_.axis_bcs(mesh, cavity_bcs())
            lvl = mg_mod._build_level(mesh, axbcs, 0.01, dtype, "cuda")
            p, b = (torch.as_tensor(rng.standard_normal(mesh.cell_shape), dtype=dtype,
                                    device="cuda") for _ in range(2))
            for mode in cuda_stencil.POISSON_MODES:
                args = {"apply": (), "residual": (b,),
                        "smooth": (b, lvl.inv_diag, 0.8)}[mode]
                got = cuda_stencil.poisson2d(mode, p, lvl.coeffs, *args)
                check_kernel(entries["poisson2d" + sfx], f"poisson2d {mode} {N}^2", dtype,
                             (got,), (cuda_stencil.poisson2d_plain(mode, p, lvl.coeffs,
                                                                   *args),),
                             cuda_stencil.poisson2d)
                t = time_one(
                    f"poisson2d {mode} {N}^2 {dname}",
                    lambda: cuda_stencil.poisson2d(mode, p, lvl.coeffs, *args),
                    lambda: cuda_stencil.poisson2d_plain(mode, p, lvl.coeffs, *args),
                    nbytes(p, p, *args, *coeff_tensors(lvl.coeffs)),
                    N * N * FLOPS_PER_CELL["poisson2d"][mode])
                if N == 256 and mode == "apply":
                    entries["poisson2d" + sfx].update(t)
                if N == 4096:
                    large = entries["poisson2d" + sfx].setdefault("at_4096", {"plan": asdict(
                        cuda_stencil.poisson2d_launch_plan((N, N), dtype))})
                    large[mode] = t
        for N, planes, reps in ((256, W.to(dtype), {}),
                                (4096, None, {"calls": 5, "replays": 4, "iters": 10})):
            kind = "random" if planes is None else name
            if planes is None:
                planes = torch.randn((26, N, N), generator=gen, device="cuda").to(dtype)
            u, v = (torch.as_tensor(rng.standard_normal(planes.shape[1:]),
                                    dtype=dtype, device="cuda") for _ in range(2))
            check_kernel(entries["momentum2d" + sfx], f"momentum2d {N}^2 {kind}", dtype,
                         cuda_stencil.momentum2d(planes, u, v, per),
                         cuda_stencil.momentum2d_plain(planes, u, v, per),
                         cuda_stencil.momentum2d)
            t = time_one(
                f"momentum2d {N}^2 {dname} ({kind} planes)",
                lambda: cuda_stencil.momentum2d(planes, u, v, per),
                lambda: cuda_stencil.momentum2d_plain(planes, u, v, per),
                nbytes(planes, u, v, u, v), N * N * FLOPS_PER_CELL["momentum2d"],
                **reps)
            if N == 256:
                entries["momentum2d" + sfx].update(t)
            else:
                entries["momentum2d" + sfx]["at_4096"] = {
                    "plan": asdict(cuda_stencil.momentum2d_launch_plan((N, N), dtype)), **t}
            del planes


def phase_slice(smi):
    """The 256^2 cavity, production preset: step + advance(20)."""
    ns = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
    ns.impl.cfg = CNLinearConfig.production()
    first, adv, launches = timed_run(ns, 20)
    if ns.step_index != 21 or not bool(ns.last_diag["converged"]):
        raise AssertionError(f"slice stopped at step {ns.step_index}: {ns.last_diag}")
    assert_finite(ns, "the 2-D cavity after 21 steps")
    require_launches(launches, ("poisson2d", "momentum2d"), "the 2-D cavity")
    umax = float(ns.state["v"][0].abs().max())
    if not 0.5 < umax < 1.5:
        raise AssertionError(f"|u|max {umax} out of the lid-driven range")
    print(f"[slice] cavity 256^2 Re 100 f32 production: first step "
          f"{first * 1e3:.2f} ms, advance(20) {adv * 1e3:.2f} ms = "
          f"{20 / adv:.3f} steps/s warm ({smi}); ksp_rnorm "
          f"{float(ns.last_diag['ksp_rnorm']):.4g}; |u|max {umax:.4f}; "
          f"launches {launches}", flush=True)

    # the fixed-budget step reads nothing back to the host: a
    # synchronising call inside it raises here (torch's sync debug mode
    # is a prototype and may miss some kinds of synchronisation)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ns.impl.multi_step(ns.state, ns.t, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # three more windows: the spread of the host-bound step loop
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ns.advance(20)
        torch.cuda.synchronize()
        rates.append(20 / (time.perf_counter() - t0))
    print(f"[slice] sync debug mode flagged no synchronisation inside a "
          f"production step; "
          f"steps/s over 3 more advance(20) windows: "
          f"{', '.join(f'{r:.3f}' for r in rates)}", flush=True)

    # 5 steps on the card (f32) against the plain f64 run on the CPU
    states = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        ref = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device=device, dtype=dtype)
        ref.impl.cfg = CNLinearConfig.production()
        ref.advance(5)
        states[device] = ref.state
    errs = {
        "v": max(rel_err(states["cuda"]["v"][c].cpu(), states["cpu"]["v"][c])
                 for c in range(2)),
        "p": rel_err(states["cuda"]["p"].cpu(), states["cpu"]["p"]),
    }
    for k, e in errs.items():
        if not e <= SLICE_RTOL[k]:
            raise AssertionError(f"5-step {k}: card f32 vs CPU f64 rel err "
                                 f"{e:.3e} > {SLICE_RTOL[k]:g}")
    print(f"[slice] 5 steps card f32 vs CPU f64: rel err v {errs['v']:.3e} "
          f"(bound {SLICE_RTOL['v']:g}), p {errs['p']:.3e} (bound "
          f"{SLICE_RTOL['p']:g})", flush=True)
    return launches, states["cpu"]


def bf16_precond(cfg, scope="both"):
    """``cfg`` with the bf16 ABF preconditioner on ``scope``."""
    cfg.precond_dtype = "bfloat16"
    cfg.precond_scope = scope
    return cfg


def phase_slice_bf16(smi, cpu_state):
    """The 256^2 cavity, production(3, 8, 6) with the bf16 preconditioner
    on both inner solves (the reference's skipped
    tests/test_bf16_precond.py:93-103 case, at full size): step +
    advance(20); then 5 steps against the plain float64 run on the CPU
    without it (``cpu_state``), with bf16 on both inner solves (printed,
    no check) and on the momentum solve alone (SLICE_BF16_RTOL). At this
    CFL (2.56) the production budget leaves the steps unresolved in any
    precision, and with bf16 on both inner solves |u|max swings between
    ~0.01 and ~1.5 from step to step over the first 22 steps, in
    fluca_tpu's own code run op by op on the CPU too
    (tests/test_torch_bf16_witness.py cavity256): the run is held to
    finite fields and its kernels, and its |u|max at steps 21 and 22 is
    printed, not gated."""
    ns = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
    ns.impl.cfg = bf16_precond(CNLinearConfig.production(3, 8, 6))
    first, adv, launches = timed_run(ns, 20)
    if ns.step_index != 21 or not bool(ns.last_diag["converged"]):
        raise AssertionError(f"bf16 slice stopped at step {ns.step_index}: "
                             f"{ns.last_diag}")
    assert_finite(ns, "the bf16-preconditioned 2-D cavity after 21 steps")
    require_launches(launches, ("poisson2d_bf16", "momentum2d_bf16"),
                     "the bf16-preconditioned 2-D cavity")
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = ns.impl.multi_step(ns.state, ns.t, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    umax = [float(x["v"][0].abs().max()) for x in (ns.state, st)]
    print(f"[slice-bf16] cavity 256^2 Re 100 f32 production(3, 8, 6), bf16 "
          f"preconditioner (both): first step {first * 1e3:.2f} ms, advance(20) "
          f"{adv * 1e3:.2f} ms = {20 / adv:.3f} steps/s warm ({smi}); ksp_rnorm "
          f"{float(ns.last_diag['ksp_rnorm']):.4g}; |u|max at steps 21 and 22 "
          f"{umax[0]:.4f}, {umax[1]:.4f} (not gated); launches {launches}; per "
          f"step {per_step(launches, 21)}", flush=True)
    print("[slice-bf16] sync debug mode flagged no synchronisation inside a "
          "bf16-preconditioned step", flush=True)

    for scope in ("both", "mom"):
        ref = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
        ref.impl.cfg = bf16_precond(CNLinearConfig.production(3, 8, 6), scope)
        ref.advance(5)
        errs = {
            "v": max(rel_err(ref.state["v"][c].cpu(), cpu_state["v"][c])
                     for c in range(2)),
            "p": rel_err(ref.state["p"].cpu(), cpu_state["p"]),
        }
        if scope == "both":
            assert_finite(ref, "the bf16-preconditioned 2-D cavity after 5 steps")
            print(f"[slice-bf16] 5 steps card (bf16 preconditioner, both) vs CPU f64 "
                  f"production: rel err v {errs['v']:.3e}, p {errs['p']:.3e} (no "
                  f"check: the startup swing, see SLICE_BF16_RTOL)", flush=True)
            continue
        for k, e in errs.items():
            if not e <= SLICE_BF16_RTOL[k]:
                raise AssertionError(f"bf16 ({scope}) 5-step {k}: card vs CPU f64 "
                                     f"rel err {e:.3e} > {SLICE_BF16_RTOL[k]:g}")
        print(f"[slice-bf16] 5 steps card (bf16 preconditioner, {scope}) vs CPU "
              f"f64 production: rel err v {errs['v']:.3e} (bound "
              f"{SLICE_BF16_RTOL['v']:g}), p {errs['p']:.3e} (bound "
              f"{SLICE_BF16_RTOL['p']:g})", flush=True)
    return launches


def witness_inputs(mesh):
    """The inputs of tests/test_torch_bf16_witness.py, made from the same
    seeds: the Schur rhs (random and smooth, zero mean), and U0, v0f and
    the rhs of the momentum solve."""
    N = mesh.N[0]
    random = np.random.default_rng(0).standard_normal((N, N))
    x = np.linspace(0.0, 1.0, N)
    smooth = (np.sin(3 * np.pi * x)[:, None] * np.cos(2 * np.pi * x)[None, :]
              + 0.01 * np.random.default_rng(0).standard_normal((N, N)))
    rng = np.random.default_rng(1)
    U0 = tuple(0.5 * rng.standard_normal(mesh.face_shape(d)) for d in range(2))
    v0f = tuple(tuple(0.5 * rng.standard_normal(mesh.face_shape(d)) for _ in range(2))
                for d in range(2))
    rhs = tuple(rng.standard_normal(mesh.cell_shape) for _ in range(2))
    return ({"random": random - random.mean(), "smooth": smooth - smooth.mean()},
            (U0, v0f, rhs))


def phase_inner_bf16(entries):
    """The two bf16 inner solves of the 128^2 cavity's preconditioner on
    the card, against the exact float64 solution on the CPU: see
    INNER_BF16_MAX."""
    def solver(device, dtype, cfg):
        ns = setup_cavity_2d(N=128, Re=100.0, dt=0.005, device=device, dtype=dtype)
        ns.impl.cfg = cfg
        return ns

    card = solver("cuda", torch.float32,
                  bf16_precond(CNLinearConfig.production(3, 8, 6)))
    check_solver_stencils(entries, "cavity 128^2 (bf16 inner solves)", card)
    card = card.impl
    exact = solver("cpu", torch.float64, CNLinearConfig(
        schur_rtol=1e-13, schur_maxiter=2000, mom_rtol=1e-13, mom_maxiter=2000)).impl
    schur_rhs, (U0, v0f, rhs) = witness_inputs(card.mesh)
    errs = {}
    for kind, b in schur_rhs.items():
        want = exact._solve_schur(torch.tensor(b))
        got = card._solve_schur(torch.tensor(b, device="cuda").to(BF16),
                                mg=card._pre_resources()["mg"])
        if got.dtype != BF16:
            raise AssertionError(f"the bf16 Schur solve returned {got.dtype}")
        errs[f"schur {kind}"] = rel_err(got.cpu().double(), want)

    def t(xs, dtype, device):
        return tuple(torch.tensor(x, dtype=dtype, device=device) for x in xs)

    U64, v64 = t(U0, torch.float64, "cpu"), tuple(t(r, torch.float64, "cpu") for r in v0f)
    want = exact._solve_momentum(t(rhs, torch.float64, "cpu"),
                                 exact.ops.build_momentum_operator(U64, v64),
                                 exact.ops.diag_A(U64, v64))
    U32 = t(U0, torch.float32, "cuda")
    v32 = tuple(t(r, torch.float32, "cuda") for r in v0f)
    ctx = card._precond_ctx(card.ops.build_momentum_operator(U32, v32),
                            card.ops.diag_A(U32, v32), U32, v32)
    got = card._solve_momentum(t(rhs, BF16, "cuda"), ctx["Acoeffs"], ctx["diagA"])
    errs["momentum"] = vec_rel_err([x.cpu().double() for x in got], want)
    for k, e in errs.items():
        print(f"[inner-bf16] cavity 128^2 bf16 {k} solve on the card vs the exact "
              f"f64 solution: rel err {e:.4e} (gate <= {INNER_BF16_MAX[k]:g})",
              flush=True)
        if not e <= INNER_BF16_MAX[k]:
            raise AssertionError(f"bf16 {k} solve: rel err {e:.4e} > "
                                 f"{INNER_BF16_MAX[k]:g}")


def phase_budget_bf16(entries):
    """fluca_tpu's accuracy pin of the bf16 preconditioner
    (examples/tune_budget_tpu.py) on the card: see BUDGET_MAX_DEV."""
    def run(cfg):
        ns = setup_cavity_2d(N=128, Re=100.0, dt=0.005, device="cuda")
        ns.impl.cfg = cfg
        check_solver_stencils(entries, "cavity 128^2 (accuracy pin)", ns)
        ns.advance(50)
        return [*ns.state["v"], ns.state["p"]]

    t0 = time.perf_counter()
    ref = run(CNLinearConfig())
    for label, cfg in (("f32", CNLinearConfig.production(3, 8, 6)),
                       ("bf16", bf16_precond(CNLinearConfig.production(3, 8, 6)))):
        dev = max(max_abs(a, b) for a, b in zip(run(cfg), ref))
        print(f"[budget-bf16] cavity 128^2 dt 0.005, 50 steps, production(3, 8, "
              f"6) {label} preconditioner: max |dev| from the converged FGMRES "
              f"rtol 1e-5 solve {dev:.4e} U_lid (gate <= {BUDGET_MAX_DEV[label]:g})",
              flush=True)
        if not dev <= BUDGET_MAX_DEV[label]:
            raise AssertionError(f"budget pin ({label}): max dev {dev:.4e} > "
                                 f"{BUDGET_MAX_DEV[label]:g}")
    print(f"[budget-bf16] done in {time.perf_counter() - t0:.2f} s", flush=True)


def phase_app(entries):
    """The 2-D app, after its solver's kernels at their shapes."""
    argv = ["-device", "cuda", "-cart_grid_x", "256", "-cart_grid_y", "256",
            "-ns_max_steps", "3", "-ns_monitor"]
    check_solver_stencils(entries, "app 256^2", app.build(argv))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(argv)
    out = buf.getvalue()
    print(out, end="")
    if rc != 0 or "done: CONVERGED_ITS" not in out:
        raise AssertionError(f"app run did not end CONVERGED_ITS (rc {rc})")
    print(f"[app] 3 FGMRES rtol 1e-5 steps at 256^2 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# ----------------------------------------------------------------------
# 3-D
# ----------------------------------------------------------------------

def vec_rel_err(a, b) -> float:
    """||a - b|| / ||b|| over tuples of fields taken as one vector."""
    num = sum(float(torch.sum((x.double() - y.double()) ** 2)) for x, y in zip(a, b))
    den = sum(float(torch.sum(y.double() ** 2)) for y in b)
    return (num / den) ** 0.5


def runs3d(dtype, entries):
    """The 64x64x32 cavity and the stretched 128^3 channel after 2
    production steps on the card (their chain checked first)."""
    cav = setup_cavity_3d(N=(64, 64, 32), Re=100.0, dt=0.01, device="cuda",
                          dtype=dtype)
    chan = setup_channel_3d(N=(128, 128, 128), stretch_y=2.0, dt=2e-3,
                            device="cuda", dtype=dtype)
    cases = (("cavity 64x64x32", cav), ("channel 128^3 stretched", chan))
    for name, ns in cases:
        ns.impl.cfg = CNLinearConfig.production()
        check_chain_solver(entries, f"{name} {DTYPE_NAMES[dtype]}", ns)
        ns.advance(2)
    return cases


def check_poisson_modes(results, label, rng, coeffs, inv_diag):
    """The three modes of the Poisson kernel of the coefficients'
    dimension against its plain version on one level's coefficients,
    with fields in ``inv_diag``'s dtype; returns the number of checks."""
    if len(coeffs.shape) == 2:
        kernel, plain = cuda_stencil.poisson2d, cuda_stencil.poisson2d_plain
    else:
        kernel, plain = cuda_stencil.poisson3d, cuda_stencil.poisson3d_plain
    dtype = inv_diag.dtype
    p, b = (torch.as_tensor(rng.standard_normal(coeffs.shape), dtype=dtype,
                            device="cuda") for _ in range(2))
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, inv_diag, 0.8)}[mode]
        got = kernel(mode, p, coeffs, *args)
        ref = plain(mode, p, coeffs, *args)
        torch.cuda.synchronize()
        check_kernel(results, f"{kernel.name} {mode} {label} {coeffs.shape}", dtype,
                     (got,), (ref,), kernel)
    return len(cuda_stencil.POISSON_MODES)


def check_poisson3d(results, runs):
    """Every mode, both dtypes, on every multigrid level of the cavity
    (walls and a SYMMETRY plane) and of the stretched channel (periodic
    x and z)."""
    rng = np.random.default_rng(3)
    n_checks = 0
    for cases in runs.values():
        for name, ns in cases:
            for lvl in ns.impl.mg.levels:
                n_checks += check_poisson_modes(results, name, rng, lvl.coeffs,
                                                lvl.inv_diag)
    report("poisson3d", n_checks, results)


def mixed_bc_ops(dtype):
    """Walls, a PRESSURE_OUTLET (+x) and a SYMMETRY plane (-z) on a
    non-uniform 64x48x40 grid: NSOperators with random face factors."""
    N = (64, 48, 40)
    mesh = CartMesh.create(N)
    mesh.set_coordinates(*[np.linspace(0.0, 1.0, n + 1) ** 1.2 for n in N])
    wall = zero_velocity_bc()
    out = BoundaryCondition(BCType.PRESSURE_OUTLET, pressure=lambda t, xs: 0.0 * xs[0])
    sym = BoundaryCondition(BCType.SYMMETRY)
    ops = NSOperators(mesh, [wall, out, wall, wall, sym, wall], 1.3, 0.02, 0.01, dtype,
                      "cuda")
    rng = np.random.default_rng(4)

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

    U0 = tuple(rand(mesh.face_shape(d)) for d in range(3))
    v0f = tuple(tuple(rand(mesh.face_shape(d)) for _ in range(3)) for d in range(3))
    return ops, ops.build_momentum_factors_3d(U0, v0f)


def check_momentum3d(results, runs):
    rng = np.random.default_rng(5)
    n_checks = 0
    for dtype, cases in runs.items():
        factors = [(name, ns.impl.ops, ns.impl.ops.build_momentum_factors_3d(
            ns.state["U"], step_v0f(ns.impl.ops, ns.state, ns.t))) for name, ns in cases]
        factors.append(("mixed outlet/symmetry", *mixed_bc_ops(dtype)))
        for name, ops, f in factors:
            v = tuple(torch.as_tensor(rng.standard_normal(ops.mesh.cell_shape),
                                      dtype=dtype, device="cuda") for _ in range(3))
            got = cuda_stencil.momentum3d(ops.mom_bands3d, f, v)
            ref = cuda_stencil.momentum3d_plain(ops.mom_bands3d, f, v)
            torch.cuda.synchronize()
            check_kernel(results, f"momentum3d {name}", dtype, got, ref,
                         cuda_stencil.momentum3d)
            n_checks += 1
    report("momentum3d", n_checks, results)


def check_channel512(poisson, momentum, ns):
    """The 3-D kernels against their plain versions at the shapes of the
    512x256x256 channel: the three Poisson modes on every multigrid
    level and the momentum kernel on the current step factors. float32
    as the run holds them; float64 on the same arrays widened."""
    rng = np.random.default_rng(7)
    ops = ns.impl.ops
    bands = ops.mom_bands3d
    U0, v0f = ns.state["U"], step_v0f(ops, ns.state, ns.t)
    n_poisson = n_momentum = 0
    for dtype in (torch.float32, torch.float64):
        for lvl in ns.impl.mg.levels:
            c = lvl.coeffs
            coeffs = cuda_stencil.Poisson3DCoeffs(
                *(x.to(dtype) for x in (c.a0, c.c1, c.c2, c.h0, c.h1, c.h2)),
                c.periodic)
            n_poisson += check_poisson_modes(poisson, "channel 512", rng, coeffs,
                                             lvl.inv_diag.to(dtype))
        bands_d = cuda_stencil.Momentum3DBands(tuple(B.to(dtype) for B in bands.b),
                                               bands.periodic)
        f = cuda_stencil.Momentum3DFactors.from_faces(U0, v0f, bands_d)
        v = tuple(torch.as_tensor(rng.standard_normal(ns.mesh.cell_shape), dtype=dtype,
                                  device="cuda") for _ in range(3))
        got = cuda_stencil.momentum3d(bands_d, f, v)
        ref = cuda_stencil.momentum3d_plain(bands_d, f, v)
        torch.cuda.synchronize()
        check_kernel(momentum, "momentum3d channel 512", dtype, got, ref,
                     cuda_stencil.momentum3d)
        n_momentum += 1
        del f, v, got, ref
    report("poisson3d (with the 512x256x256 channel's levels)", n_poisson, poisson)
    report("momentum3d (with the 512x256x256 channel's factors)", n_momentum, momentum)


def check_bf16_3d(poisson, momentum, label, ns, mg16):
    """The 3-D bf16 instances at the shapes of ``ns``: the Poisson modes
    on every level of the bf16 hierarchy ``mg16``, the momentum kernel on
    the current step's factors built in bf16 from U0 and v0f, as the
    preconditioner builds them."""
    rng = np.random.default_rng(12)
    n_poisson = sum(check_poisson_modes(poisson, label, rng, lvl.coeffs, lvl.inv_diag)
                    for lvl in mg16.levels)
    ops = ns.impl.ops
    bands = ops.momentum_bands_3d(BF16)
    f = ops.build_momentum_factors_3d(ns.state["U"], step_v0f(ops, ns.state, ns.t),
                                      BF16)
    v = tuple(torch.as_tensor(rng.standard_normal(ns.mesh.cell_shape), dtype=BF16,
                              device="cuda") for _ in range(3))
    got = cuda_stencil.momentum3d(bands, f, v)
    ref = cuda_stencil.momentum3d_plain(bands, f, v)
    torch.cuda.synchronize()
    check_kernel(momentum, f"momentum3d {label}", BF16, got, ref,
                 cuda_stencil.momentum3d)
    report(f"poisson3d_bf16 (with the {label} bf16 levels)", n_poisson, poisson)
    report(f"momentum3d_bf16 (with the {label} step factors)", 1, momentum)


def check_solver_stencils(entries, label, ns):
    """The Poisson kernel's modes on every multigrid level of the solver
    of ``ns``, and the momentum kernel on its current step's
    coefficients, in the solver dtype; and where its preconditioner runs
    in bf16, the bf16 instances on its bf16 hierarchy and coefficients:
    for the solvers whose shapes no other check covers."""
    impl, ops = ns.impl, ns.impl.ops
    rng = np.random.default_rng(16)
    dim = ns.mesh.dim
    pname, mname = ("poisson2d", "momentum2d") if dim == 2 else ("poisson3d", "momentum3d")
    pre = impl._pre_resources()
    cases = [(impl.dtype, impl.mg, "")]
    if pre is not None:
        cases.append((pre["dtype"], pre["mg"], "_bf16" if pre["dtype"] == BF16 else ""))
    v0f = step_v0f(ops, ns.state, ns.t)
    n = 0
    for dtype, mg, sfx in cases:
        if mg is not None:
            n += sum(check_poisson_modes(entries[pname + sfx], label, rng, lvl.coeffs,
                                         lvl.inv_diag) for lvl in mg.levels)
        v = tuple(torch.as_tensor(rng.standard_normal(ns.mesh.cell_shape), dtype=dtype,
                                  device="cuda") for _ in range(dim))
        if dim == 2:
            W = ops.build_momentum_coeffs_stacked(ns.state["U"], v0f).to(dtype)
            got = cuda_stencil.momentum2d(W, *v, ns.mesh.periodic)
            ref = cuda_stencil.momentum2d_plain(W, *v, ns.mesh.periodic)
        else:
            bands = ops.momentum_bands_3d(dtype)
            f = ops.build_momentum_factors_3d(ns.state["U"], v0f, dtype)
            got = cuda_stencil.momentum3d(bands, f, v)
            ref = cuda_stencil.momentum3d_plain(bands, f, v)
        torch.cuda.synchronize()
        check_kernel(entries[mname + sfx], f"{mname} {label}", dtype, got, ref,
                     getattr(cuda_stencil, mname))
        n += 1
    print(f"[kernels] {label}: {n} checks of {pname} and {mname} on the solver's "
          f"levels and coefficients", flush=True)


# ----------------------------------------------------------------------
# the 3-D chain
# ----------------------------------------------------------------------

CHAIN_KERNELS = {"coupled": cuda_stencil.chain3d_coupled, "pre": cuda_stencil.chain3d_pre,
                 "post": cuda_stencil.chain3d_post}
CHAIN_NAMES = tuple(k.name for k in CHAIN_KERNELS.values())
# the solver's method of each stage (Chain3D and UnfusedChain)
CHAIN_METHODS = {"coupled": "coupled", "pre": "abf_pre", "post": "abf_post"}


def unchain(ns, stages=None):
    """Point the solver of ``ns`` at its UnfusedChain (the banded
    operators), or at ``stages``: the A/B and planted-fault runs of
    phase_chain_ab. Nothing else in the port sets the solver's stages."""
    ns.impl._stages = ns.impl._unfused if stages is None else stages


def flat(groups):
    """The tensors of a chain stage's groups, in order."""
    return [t for g in groups for t in ((g,) if torch.is_tensor(g) else g)]


def chain_inputs(chain, stage, gen):
    """Random inputs of ``stage`` at the shapes of ``chain``, in its
    dtype, made on the card."""
    dtype = chain.b[0].dtype

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def cells():
        return tuple(rand(chain.shape) for _ in range(3))

    faces = tuple(rand(cuda_stencil._face_shape(chain.shape, chain.periodic, d))
                  for d in range(3))
    if stage == "coupled":
        return cells(), cells(), faces, rand(chain.shape)
    return cells(), faces, rand(chain.shape)


def check_chain(entries, label, chain, gen):
    """Each stage's kernel against chain3d_plain on ``chain``'s bands and
    random fields; returns the number of checks."""
    dtype = chain.b[0].dtype
    for stage, kernel in CHAIN_KERNELS.items():
        groups = chain_inputs(chain, stage, gen)
        got = kernel(chain, *groups)
        ref = chain3d_plain(stage, chain.b, chain.periodic, *groups)
        torch.cuda.synchronize()
        check_kernel(entries[kernel.name], f"{kernel.name} {label} {chain.shape}", dtype,
                     flat(got), flat(ref), kernel)
        entries[kernel.name]["checks"] += 1
        del groups, got, ref
    return len(CHAIN_KERNELS)


def solver_chains(impl):
    """The solver's Chain3D and its twin in the other of float32 and
    float64, built from the same host bands (the same fingerprint)."""
    if not isinstance(impl._stages, Chain3D):
        raise AssertionError(f"a 3-D solver runs {type(impl._stages).__name__}, not Chain3D")
    other = torch.float64 if impl.dtype == torch.float32 else torch.float32
    return (impl._stages, Chain3D(impl.mesh, impl.ops.axbcs, impl.rho, impl.dt, other,
                                  impl.device))


def check_chain_solver(entries, label, ns):
    """The three stages in float32 and float64 on the bands of the 3-D
    solver of ``ns``, before it runs."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    n = sum(check_chain(entries, label, chain, gen) for chain in solver_chains(ns.impl))
    print(f"[chain3d] {label}: {n} stage checks on the solver's bands "
          f"({ns.impl._stages.fingerprint})", flush=True)


def check_chain_pairs(entries):
    """The three stages, float32 and float64, at 16^3 and 37x29x33 on
    non-uniform grids, with every lo/hi pair of VELOCITY,
    PRESSURE_OUTLET, SYMMETRY (and PERIODIC) on all three axes."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    kinds = (BCType.VELOCITY, BCType.PRESSURE_OUTLET, BCType.SYMMETRY)
    pairs = [*itertools.product(kinds, kinds), (BCType.PERIODIC, BCType.PERIODIC)]
    n = 0
    for N in ((16, 16, 16), (37, 29, 33)):
        for lo, hi in pairs:
            per = lo == BCType.PERIODIC
            mesh = CartMesh.create(N, (per,) * 3)
            mesh.set_coordinates(*[np.linspace(0.0, 1.0, m + 1) ** 1.2 for m in N])
            for dtype in (torch.float32, torch.float64):
                chain = Chain3D(mesh, [T_.AxisBC(lo, hi)] * 3, 1.3, 0.01, dtype, "cuda")
                n += check_chain(entries, f"{lo.name}/{hi.name}", chain, gen)
    print(f"[chain3d] {n} stage checks at 16^3 and 37x29x33, every lo/hi pair", flush=True)


def chain_flops(stage, chain):
    """Operations of one stage, counted from the bands of this run: a
    multiply and an add per nonzero band entry applied, and two more per
    output element (the terms' sum with the stage's other input)."""
    host = [B.double().cpu().numpy() for B in chain.b]
    rows = {"coupled": (("G", False), ("D", False), ("T", True), ("R", True)),
            "pre": (("T", True), ("D", False), ("DT", False)),
            "post": (("G", False), ("Gst", True))}[stage]
    terms = 0
    for a in range(3):
        rest = int(np.prod([n for d, n in enumerate(chain.shape) if d != a]))
        for op, to_faces in rows:
            n_out = chain.shape[a] + (1 if to_faces and not chain.periodic[a] else 0)
            nz = sum(int(np.count_nonzero(host[a][r, :n_out])) for r in CHAIN_ROWS[op].values())
            terms += nz * rest
    outputs = sum(t.numel() for t in flat(chain_outputs(chain, stage)))
    return 2 * terms + 2 * outputs


def chain_outputs(chain, stage):
    """A stage's outputs as tensors on the meta device, for counting."""
    _, outs = cuda_stencil.CHAIN_STAGES[stage]
    out = []
    for _, kind, count in outs:
        ts = tuple(torch.empty(chain.shape if kind == "cell" else cuda_stencil._face_shape(
            chain.shape, chain.periodic, e), device="meta") for e in range(count))
        out.append(ts[0] if count == 1 else ts)
    return out


def device_launches(fn):
    """The kernels one fn() call runs on the card, by torch.profiler;
    None when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA" and getattr(e, "self_device_time_total", 0) > 0)
    return n or None


def time_chain(label, ns, calls=50, replays=20, iters=200):
    """Each stage's kernel, its plain version and the unfused sequence
    (UnfusedChain, the banded operators) on the bands of the solver of
    ``ns`` and random fields, with the kernel's bound; returns each
    stage's times."""
    chain, unfused = ns.impl._stages, ns.impl._unfused
    gen = torch.Generator(device="cuda").manual_seed(15)
    reps = {"calls": calls, "replays": replays, "iters": iters}
    out = {}
    for stage, kernel in CHAIN_KERNELS.items():
        groups = chain_inputs(chain, stage, gen)
        method = getattr(unfused, CHAIN_METHODS[stage])
        moved = nbytes(*flat(groups), *chain.b) + sum(
            t.numel() * chain.b[0].element_size() for t in flat(chain_outputs(chain, stage)))
        t = time_one(f"{kernel.name} {label} {DTYPE_NAMES[chain.b[0].dtype]}",
                     lambda: kernel(chain, *groups),
                     lambda: chain3d_plain(stage, chain.b, chain.periodic, *groups),
                     moved, chain_flops(stage, chain), **reps)
        t["unfused_ms"] = graph_ms(lambda: method(*groups), calls, replays)
        t["unfused_launches"] = device_launches(lambda: method(*groups))
        print(f"[time] {kernel.name} {label}: the unfused sequence (banded operators) "
              f"{t['unfused_ms']:.5f} ms on the device in {t['unfused_launches']} "
              f"launches; the kernel {t['ms']:.5f} ms in 1", flush=True)
        out[kernel.name] = t
        del groups
    return out


def field_dists(a, b, vol):
    """||a - b|| / ||b|| over v, over U and over p without its
    volume-weighted mean, in float64."""
    def pm(p):
        p = p.double()
        return p - torch.sum(vol * p) / torch.sum(vol)

    return {"v": vec_rel_err(a["v"], b["v"]), "U": vec_rel_err(a["U"], b["U"]),
            "p": rel_err(pm(a["p"]), pm(b["p"]))}


def planted_fault(impl, axis=1, op="R", off=0):
    """The solver's chain with one band row zeroed (by default R at
    offset 0 on the wall-normal axis of the channel), with the
    fingerprint of its bands: a fault for phase_chain_ab to find."""
    host = build_chain_bands(impl.mesh, impl.ops.axbcs, impl.rho, impl.dt)
    host[axis][CHAIN_ROWS[op][off]] = 0.0
    bad = Chain3D(impl.mesh, impl.ops.axbcs, impl.rho, impl.dt, impl.dtype, impl.device)
    bad.b = tuple(torch.as_tensor(B, dtype=impl.dtype, device=impl.device) for B in host)
    bad.fingerprint = bands_fingerprint(host, bad.periodic)
    return bad


def phase_chain_ab(entries):
    """The 3-D step chained (the solver's Chain3D) against unchained
    (its UnfusedChain), float64, production: the 128^3 channel's first
    step, gated by the unchained step's own distance from a run one
    rounding away; 11 steps of the 64^3 channel, gated by AB64_MAX; and
    a planted fault through each comparison, which must exceed its
    bound."""
    def channel(N):
        ns = setup_channel_3d(N=N, dt=2e-3, device="cuda", dtype=torch.float64)
        ns.impl.cfg = CNLinearConfig.production()
        return ns

    def runs(N, nsteps, labels):
        """The final state of each run, and the grid's cell volumes."""
        out = {}
        for label in labels:
            ns = channel(N)
            if label == "chained":
                check_chain_solver(entries, f"channel {N[0]}^3 f64", ns)
                check_solver_stencils(entries, f"channel {N[0]}^3 f64", ns)
            elif label == "planted fault":
                bad = planted_fault(ns.impl)
                check_chain(entries, "planted fault", bad, torch.Generator(device="cuda"))
                unchain(ns, bad)
            else:
                unchain(ns)
            if label == "moved":
                ns.state["v"] = tuple(x * (1.0 + 2.0 ** -52) for x in ns.state["v"])
            ns.advance(nsteps)
            assert_finite(ns, f"the {N[0]}^3 channel, {label}")
            out[label] = ns.state
            vol = torch.as_tensor(ns.mesh.cell_volumes(), device="cuda")
            del ns
        return out, vol

    def report(label, got, bound, fault):
        print(f"[chain-ab] {label}, chained vs unchained: "
              + ", ".join(f"{k} {got[k]:.4e} (bound {bound[k]:.4e})" for k in got)
              + "; the planted fault (R row 0 of axis 1 zeroed): "
              + ", ".join(f"{k} {fault[k]:.4e}" for k in fault), flush=True)
        for k in got:
            if not got[k] <= bound[k] < 1.0:
                raise AssertionError(f"{label}, chained vs unchained {k}: {got[k]:.4e}, "
                                     f"bound {bound[k]:.4e}")
        if not any(fault[k] > bound[k] for k in fault):
            raise AssertionError(f"{label}: the planted fault passed: {fault}")

    t0 = time.perf_counter()
    st, vol = runs((128, 128, 128), 1, ("chained", "unchained", "moved", "planted fault"))
    moved = field_dists(st["moved"], st["unchained"], vol)
    print(f"[chain-ab] channel 128^3 f64, first production step: one rounding of v "
          f"moves the unchained step by "
          + ", ".join(f"{k} {moved[k]:.4e}" for k in moved), flush=True)
    report("channel 128^3 f64, first production step",
           field_dists(st["chained"], st["unchained"], vol), moved,
           field_dists(st["planted fault"], st["unchained"], vol))
    del st
    st, vol = runs((64, 64, 64), 11, ("chained", "unchained", "planted fault"))
    report("channel 64^3 f64, 11 production steps",
           field_dists(st["chained"], st["unchained"], vol), AB64_MAX,
           field_dists(st["planted fault"], st["unchained"], vol))
    print(f"[chain-ab] done in {time.perf_counter() - t0:.2f} s", flush=True)


def phase_ledger():
    """Each kernel's ledger: the (shape, instance, band set) keys it
    launched at, and those no check covered. Fails if a key of the chain
    or of any other kernel went unchecked."""
    gaps = {}
    for k in (*cuda_stencil.KERNELS, *probes.KERNELS):
        missing = k.unchecked()
        print(f"[ledger] {k.name}: {len(k.launched)} keys launched, "
              f"{len(k.launched & k.checked)} of them checked against the plain "
              f"version; unchecked: {sorted(missing) or 'none'}", flush=True)
        if missing:
            gaps[k.name] = missing
    if gaps:
        raise AssertionError(f"kernels launched at unchecked keys: {gaps}")


def time_kernels3d(label, ns, dtype, calls=50, replays=20, iters=200):
    """The 3-D kernels' ``dtype`` instances against their plain versions
    on the finest level and the current step factors of ``ns``, ``calls``
    launches per CUDA graph; returns the times of the three Poisson modes
    and of the momentum apply."""
    rng = np.random.default_rng(6)
    shape = ns.mesh.cell_shape
    n = int(np.prod(shape))
    reps = {"calls": calls, "replays": replays, "iters": iters}
    dname = DTYPE_NAMES[dtype]

    def rand():
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

    impl, ops = ns.impl, ns.impl.ops
    if dtype == impl.dtype:
        lvl = impl.mg.levels[0]
    else:
        lvl = mg_mod._build_level(ns.mesh, T_.axis_bcs(ns.mesh, ns.bcs),
                                  impl.dt / impl.rho, dtype, "cuda")
    p, b = rand(), rand()
    out = {}
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag, 0.8)}[mode]
        out[mode] = time_one(
            f"poisson3d {mode} {label} {dname}",
            lambda: cuda_stencil.poisson3d(mode, p, lvl.coeffs, *args),
            lambda: cuda_stencil.poisson3d_plain(mode, p, lvl.coeffs, *args),
            nbytes(p, p, *args, *coeff_tensors(lvl.coeffs)),
            n * FLOPS_PER_CELL["poisson3d"][mode], **reps)
    del p, b, lvl
    bands = ops.momentum_bands_3d(dtype)
    f = ops.build_momentum_factors_3d(ns.state["U"], step_v0f(ops, ns.state, ns.t),
                                      dtype)
    v = (rand(), rand(), rand())
    out["momentum"] = time_one(
        f"momentum3d {label} {dname} (step factors)",
        lambda: cuda_stencil.momentum3d(bands, f, v),
        lambda: cuda_stencil.momentum3d_plain(bands, f, v),
        nbytes(*bands.b, *v, *f.U0, *sum(f.v0f, ()), *v),
        n * FLOPS_PER_CELL["momentum3d"], **reps)
    return out


def time_momentum3d_halo(entries, label, ns, reps=None):
    """The momentum 3-D halo instance of a (2, 2, 2) grid over the mesh
    of ``ns``, float32, on its step factors: held against its plain
    version and the unsharded kernel (check_momentum3d_halo), then timed
    beside the unsharded kernel (the 512x256x256 channel's in
    phase_sharded)."""
    impl, ops = ns.impl, ns.impl.ops
    sm = build_momentum_sharded(make_device_grid(3, shape=(2, 2, 2)), ns.mesh, ops.axbcs,
                                impl.rho, impl.mu, impl.dt, torch.float32)
    v0f = step_v0f(ops, ns.state, ns.t)
    check_momentum3d_halo(entries, label, sm, ns.state["U"], v0f, np.random.default_rng(25))
    prepped = sm.prep(ns.state["U"], v0f)
    f = prepped.factors
    gen = torch.Generator(device="cuda").manual_seed(25)
    v = tuple(torch.randn(ns.mesh.N, generator=gen, device="cuda") for _ in range(3))
    ve = tuple(field_edges(sm.layout, x) for x in v)
    faces = [*f.U0, *(F for row in f.v0f for F in row)]
    return time_halo(
        f"momentum3d_halo {label} on (2, 2, 2) (step factors)", lambda: sm.apply(v, prepped),
        lambda: sm.launch(v, prepped, ve), lambda: cuda_stencil.momentum3d(sm.bands, f, v),
        lambda: cuda_stencil.momentum3d_halo_plain(sm.bands, f, v, sm.layout, ve,
                                                   prepped.face_hi),
        nbytes(*sm.bands.b, *v, *faces, *v) + sum(edge_bytes(e) for e in ve)
        + edge_bytes(prepped.face_hi), int(np.prod(ns.mesh.N)) * FLOPS_PER_CELL["momentum3d"],
        reps or {"calls": 20, "replays": 10}, plain_eager=True)


def phase_slice3d(smi, entries):
    """The 64x64x32 cavity and the 128^3 channel, production preset;
    the channel also with the bf16 preconditioner on both inner solves,
    and the 3-D bf16 instances checked on its hierarchy and factors.
    Returns the launches of the channel's float32 and bf16 runs."""
    ns = setup_cavity_3d(N=(64, 64, 32), Re=100.0, dt=0.01, device="cuda")
    ns.impl.cfg = CNLinearConfig.production()
    check_chain_solver(entries, "cavity 64x64x32", ns)
    first, adv, launches = timed_run(ns, 20)
    if ns.step_index != 21 or not bool(ns.last_diag["converged"]):
        raise AssertionError(f"3-D cavity stopped at step {ns.step_index}: "
                             f"{ns.last_diag}")
    assert_finite(ns, "the 3-D cavity after 21 steps")
    require_launches(launches, ("poisson3d", "momentum3d", *CHAIN_NAMES), "the 3-D cavity")
    umax = float(ns.state["v"][0].abs().max())
    if not 0.5 < umax < 1.5:
        raise AssertionError(f"|u|max {umax} out of the lid-driven range")
    print(f"[slice3d] cavity 64x64x32 Re 100 f32 production: first step "
          f"{first * 1e3:.2f} ms, advance(20) {adv * 1e3:.2f} ms = "
          f"{20 / adv:.3f} steps/s warm ({smi}); ksp_rnorm "
          f"{float(ns.last_diag['ksp_rnorm']):.4g}; |u|max {umax:.4f}; "
          f"launches {launches}", flush=True)

    torch.cuda.set_sync_debug_mode("error")
    try:
        ns.impl.multi_step(ns.state, ns.t, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[slice3d] sync debug mode flagged no synchronisation inside a 3-D "
          "production step", flush=True)

    chan = setup_channel_3d(N=(128, 128, 128), dt=2e-3, device="cuda")
    chan.impl.cfg = CNLinearConfig.production()
    check_chain_solver(entries, "channel 128^3", chan)
    u0 = float(chan.state["v"][0].abs().mean())
    cfirst, cadv, claunches = timed_run(chan, 10)
    if chan.step_index != 11 or not bool(chan.last_diag["converged"]):
        raise AssertionError(f"channel 128^3 stopped at step {chan.step_index}")
    assert_finite(chan, "the 128^3 channel after 11 steps")
    require_launches(claunches, ("poisson3d", "momentum3d", *CHAIN_NAMES),
                     "the 128^3 channel")
    # bench.py's 128^3 cell has no solve-quality gate: its residual and
    # mean-flow retention are printed beside the rate, not gated
    retention = float(chan.state["v"][0].abs().mean()) / u0
    print(f"[slice3d] channel 128^3 dt 2e-3 f32 production: first step "
          f"{cfirst * 1e3:.2f} ms, advance(10) {cadv * 1e3:.2f} ms = "
          f"{10 / cadv:.3f} steps/s warm ({smi}), no solve-quality gate; "
          f"ksp_rnorm {float(chan.last_diag['ksp_rnorm']):.4g}; retention "
          f"{retention:.5f} over 11 steps; launches {claunches}; per step "
          f"{per_step(claunches, 11)}", flush=True)
    del chan

    # bench.py:385-392: the same channel with the bf16 preconditioner on
    # both inner solves
    chan = setup_channel_3d(N=(128, 128, 128), dt=2e-3, device="cuda")
    chan.impl.cfg = bf16_precond(CNLinearConfig.production())
    check_chain_solver(entries, "channel 128^3 (bf16 run)", chan)
    u0 = float(chan.state["v"][0].abs().mean())
    bfirst, badv, launches_bf16 = timed_run(chan, 10)
    if chan.step_index != 11 or not bool(chan.last_diag["converged"]):
        raise AssertionError(f"bf16 channel 128^3 stopped at step {chan.step_index}")
    assert_finite(chan, "the bf16-preconditioned 128^3 channel after 11 steps")
    # the bf16 pre branch runs all three chain stages
    require_launches(launches_bf16, ("poisson3d_bf16", "momentum3d_bf16", *CHAIN_NAMES),
                     "the bf16-preconditioned 128^3 channel")
    retention = float(chan.state["v"][0].abs().mean()) / u0
    print(f"[slice3d-bf16] channel 128^3 dt 2e-3 f32 production, bf16 "
          f"preconditioner (both): first step {bfirst * 1e3:.2f} ms, advance(10) "
          f"{badv * 1e3:.2f} ms = {10 / badv:.3f} steps/s warm ({smi}), no "
          f"solve-quality gate; ksp_rnorm {float(chan.last_diag['ksp_rnorm']):.4g}; "
          f"retention {retention:.5f} over 11 steps; launches {launches_bf16}; per "
          f"step {per_step(launches_bf16, 11)}", flush=True)
    check_bf16_3d(entries["poisson3d_bf16"], entries["momentum3d_bf16"],
                  "channel 128^3", chan, chan.impl._pre16["mg"])
    del chan

    states = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        ref = setup_cavity_3d(N=(64, 64, 32), Re=100.0, dt=0.01, device=device,
                              dtype=dtype)
        ref.impl.cfg = CNLinearConfig.production()
        if device == "cuda":
            check_chain_solver(entries, "cavity 64x64x32 (5-step run)", ref)
        ref.advance(5)
        states[device] = ref.state
    errs = {
        "v": vec_rel_err([x.cpu() for x in states["cuda"]["v"]], states["cpu"]["v"]),
        "p": rel_err(states["cuda"]["p"].cpu(), states["cpu"]["p"]),
    }
    for k, e in errs.items():
        if not e <= SLICE3D_RTOL[k]:
            raise AssertionError(f"3-D 5-step {k}: card f32 vs CPU f64 rel err "
                                 f"{e:.3e} > {SLICE3D_RTOL[k]:g}")
    print(f"[slice3d] 5 cavity steps card f32 vs CPU f64: rel err v "
          f"{errs['v']:.3e} (bound {SLICE3D_RTOL['v']:g}), p {errs['p']:.3e} "
          f"(bound {SLICE3D_RTOL['p']:g})", flush=True)
    return claunches, launches_bf16


def phase_channel512(smi, entries, profile=False):
    """BASELINE config #5 at full size: 512x256x256, tanh-stretched y,
    dt 5e-5, float32, production (outer 3, BiCGStab 8, CG+MG 6). As
    bench.py's channel512 cell: retention over 1 step + advance(10),
    then the ksp_rnorm gate on the worst step of the 20-step batch that
    follows 72 steps (steps 73-92), also the timed window."""
    t0 = time.perf_counter()
    ns = setup_channel_3d(N=(512, 256, 256), dt=5e-5, stretch_y=2.0, device="cuda")
    ns.impl.cfg = CNLinearConfig.production(3, 8, 6)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check_chain_solver(entries, "channel 512x256x256", ns)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    u0 = float(ns.state["v"][0].abs().mean())
    first, adv, launches = timed_run(ns, 10)
    retention = float(ns.state["v"][0].abs().mean()) / u0
    early_rnorm = float(ns.last_diag["ksp_rnorm"])
    assert_finite(ns, "the 512x256x256 channel after 11 steps")
    require_launches(launches, ("poisson3d", "momentum3d", *CHAIN_NAMES),
                     "the 512x256x256 channel")
    print(f"[channel512] 512x256x256 stretch_y 2.0 dt 5e-5 f32 production(3, 8, 6): "
          f"setup {setup_s:.2f} s, first step {first * 1e3:.2f} ms, advance(10) "
          f"{adv * 1e3:.2f} ms; retention {retention:.5f} (gate >= {RETENTION_MIN}); "
          f"ksp_rnorm max over steps 2-11 {early_rnorm:.4g}; launches {launches}; "
          f"per step {per_step(launches, 11)}", flush=True)
    if not retention >= RETENTION_MIN:
        raise AssertionError(f"channel512 mean flow decayed: retention {retention}")
    ns.advance(61)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns.advance(20)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rnorm = float(ns.last_diag["ksp_rnorm"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert_finite(ns, "the 512x256x256 channel after 92 steps")
    print(f"[channel512] steps 73-92: advance(20) {window * 1e3:.2f} ms = "
          f"{20 / window:.4f} steps/s ({smi}); ksp_rnorm max {rnorm:.4g} (gate <= "
          f"{RNORM_MAX}); peak memory {peak:.2f} GiB", flush=True)
    if not rnorm <= RNORM_MAX:
        raise AssertionError(f"channel512 ksp_rnorm {rnorm} > {RNORM_MAX}")
    check_channel512(entries["poisson3d"], entries["momentum3d"], ns)
    time_kernels3d("512x256x256", ns, torch.float32, calls=5, replays=4, iters=10)
    time_chain("512x256x256", ns, calls=5, replays=4, iters=10)
    if profile:
        phase_profile("channel 512x256x256", ns)


def phase_channel512_bf16(smi, entries, profile=False):
    """BASELINE config #5 with the solver fluca_tpu ships for it
    (bench.py:450-454, its first attempt and the one that passed the
    round-5 gates): production(2, 6, 8) with Jacobi momentum and the bf16
    preconditioner on the momentum solve (scope "mom"), float32 outer.
    Only that combination runs: bench.py falls through four attempts on a
    failure, which here would hide a bf16 fault. The same gates and
    windows as phase_channel512; then the 3-D bf16 instances against
    their plain versions at its shapes (the Poisson modes on every level
    of a bf16 hierarchy for its grid, the momentum kernel on its step's
    factors built in bf16) and their times at 512x256x256."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ns = setup_channel_3d(N=(512, 256, 256), dt=5e-5, stretch_y=2.0, device="cuda")
    cfg = CNLinearConfig.production(2, 6, 8)
    cfg.mom_solver = "jacobi"
    ns.impl.cfg = bf16_precond(cfg, "mom")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check_chain_solver(entries, "channel 512x256x256 (bf16-momentum run)", ns)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    u0 = float(ns.state["v"][0].abs().mean())
    first, adv, launches = timed_run(ns, 10)
    retention = float(ns.state["v"][0].abs().mean()) / u0
    early_rnorm = float(ns.last_diag["ksp_rnorm"])
    assert_finite(ns, "the bf16-momentum 512x256x256 channel after 11 steps")
    # the bf16 pre branch runs all three chain stages
    require_launches(launches, ("momentum3d_bf16", "poisson3d", *CHAIN_NAMES),
                     "the bf16-momentum 512x256x256 channel")
    print(f"[channel512-bf16] 512x256x256 stretch_y 2.0 dt 5e-5 f32 production(2, 6, "
          f"8), Jacobi momentum, bf16 preconditioner (mom): setup {setup_s:.2f} s, "
          f"first step {first * 1e3:.2f} ms, advance(10) {adv * 1e3:.2f} ms; "
          f"retention {retention:.5f} (gate >= {RETENTION_MIN}); ksp_rnorm max over "
          f"steps 2-11 {early_rnorm:.4g}; launches {launches}; per step "
          f"{per_step(launches, 11)}", flush=True)
    if not retention >= RETENTION_MIN:
        raise AssertionError(f"bf16 channel512 mean flow decayed: retention {retention}")
    ns.advance(61)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns.advance(20)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rnorm = float(ns.last_diag["ksp_rnorm"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert_finite(ns, "the bf16-momentum 512x256x256 channel after 92 steps")
    print(f"[channel512-bf16] steps 73-92: advance(20) {window * 1e3:.2f} ms = "
          f"{20 / window:.4f} steps/s ({smi}); ksp_rnorm max {rnorm:.4g} (gate <= "
          f"{RNORM_MAX}); peak memory {peak:.2f} GiB", flush=True)
    if not rnorm <= RNORM_MAX:
        raise AssertionError(f"bf16 channel512 ksp_rnorm {rnorm} > {RNORM_MAX}")
    mg16 = mg_mod.PoissonMG(ns.mesh, ns.bcs, scale=ns.impl.dt / ns.impl.rho,
                            dtype=BF16, device="cuda")
    check_bf16_3d(entries["poisson3d_bf16"], entries["momentum3d_bf16"], "channel 512",
                  ns, mg16)
    del mg16
    time_kernels3d("512x256x256", ns, BF16, calls=5, replays=4, iters=10)
    if profile:
        phase_profile("channel 512x256x256 bf16-momentum", ns, ns.impl.cfg)


def phase_app3d(entries):
    """The 3-D app, after the chain's stages on its solver's bands."""
    argv = ["-device", "cuda", "-cart_dim", "3", "-cart_grid_x", "64", "-cart_grid_y",
            "64", "-cart_grid_z", "64", "-ns_max_steps", "3", "-ns_monitor"]
    ns = app.build(argv)
    check_chain_solver(entries, "app 64^3", ns)
    check_solver_stencils(entries, "app 64^3", ns)
    del ns
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(argv)
    out = buf.getvalue()
    print(out, end="")
    if rc != 0 or "done: CONVERGED_ITS" not in out:
        raise AssertionError(f"3-D app run did not end CONVERGED_ITS (rc {rc})")
    print(f"[app3d] 3 FGMRES rtol 1e-5 steps at 64^3 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# ----------------------------------------------------------------------
# the IBM wakes: BASELINE #3 and #4 from the committed checkpoints
# ----------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
# BASELINE #3, the cylinder wake at Re 100 (tests/test_shedding.py): 176x88
# on 2.2 x 1.1, D 0.1, dt 5e-3, restarted from the saturated wake at t = 30
# and advanced 64 x 5 steps (~2.6 shedding periods), C_L sampled after
# each 5; St within 5 % of 0.164 (Williamson 1996) and the C_L amplitude
# in (0.1, 0.4) (0.224 in the reference's CPU float64 run to t = 80).
CYLINDER = dict(N=(176, 88), domain=(2.2, 1.1), center=(0.55, 0.55), diameter=0.1,
                Re=100.0, dt=5e-3, max_steps=10**9)
CYLINDER_CKPT = REPO / "tests" / "data" / "cylinder_saturated_t30"
ST_REF, ST_TOL, AMP_RANGE = 0.164, 0.05, (0.1, 0.4)
# BASELINE #4 at its CI size (tests/test_sphere.py): 48x32x32 on 3 x 2 x 2,
# D 0.5, dt 0.02, restarted from the steady wake at t = 25.02 and advanced
# 25 steps; C_D must not drift by 5e-3 and must stay within 2 % of 1.4680.
SPHERE48 = dict(N=(48, 32, 32), domain=(3.0, 2.0, 2.0), center=(1.0, 1.0, 1.0),
                diameter=0.5, Re=100.0, dt=0.02, max_steps=10**9)
SPHERE48_CKPT = REPO / "tests" / "data" / "sphere_steady_t25"
CD48_REF, CD48_TOL, CD_DRIFT = 1.4680, 0.02, 5e-3
# BASELINE #4 at full width (examples/sphere_drag.py): 128^3 on 4^3, D 0.5
# at (1.5, 2, 2), markers 0.5 h inside the surface, dt 8e-3, float32, from
# uniform flow.
SPHERE128 = dict(N=(128, 128, 128), domain=(4.0, 4.0, 4.0), center=(1.5, 2.0, 2.0),
                 diameter=0.5, Re=100.0, dt=8e-3, retract=0.5, max_steps=10**9)
# The benchmark's cylinder4096 (benchmark/configs/cylinder4096.json): 4096 x
# 2048 on 64 x 32, D 1 at (16, 16), Re 100, dt 0.00625, float32, the
# solver of its cell (production(3, 8, 8)); here from uniform flow.
CYLINDER4096 = dict(N=(4096, 2048), domain=(64.0, 32.0), center=(16.0, 16.0), diameter=1.0,
                    Re=100.0, dt=0.00625, max_steps=10**9)
# The backward-facing step (examples/backward_step.py's grid): 512x64 on
# 10 x 1, Re 100, dt 0.01, the default solver, from rest; a step and
# advance(20) in float64 and float32, gated as tests/test_bfs.py gates its
# short run: finite, the inlet masked below the step and its parabola
# above, the inlet's mass flux carried to the outlet within 1e-6; and the
# float32 velocity within BFS_F32_VS_F64 of the float64 run's (4.9e-6 on
# the CPU at these steps).
BFS = dict(N=(512, 64), L=10.0, Re=100.0, dt=0.01, max_steps=10**9)
BFS_FLUX_TOL, BFS_F32_VS_F64 = 1e-6, 1e-4
KERNELS_2D = ("poisson2d", "momentum2d")
KERNELS_3D = ("poisson3d", "momentum3d", *CHAIN_NAMES)


def ibm_solver(setup, kw, dtype, ckpt=None):
    """An IBM model on the card under production(3, 8, 8), restored from
    the checkpoint ``ckpt`` where one is named."""
    ns, ibm = setup(**kw, dtype=dtype, device="cuda")
    ns.impl.cfg = CNLinearConfig.production(outer=3, mom=8, schur=8)
    if ckpt is not None:
        load_checkpoint(str(ckpt), ns)
    return ns, ibm


def counted(label, fn, steps, kernels, runs):
    """fn() with every launch count at 0 just before and read just after,
    between synchronisations; each of ``kernels`` must have launched.
    Records the run's launches per step, by kernel (all instances), in
    ``runs[label]``; returns fn's wall seconds."""
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_kernel = {k.name: k.launches for k in cuda_stencil.KERNELS}
    for name in kernels:
        if by_kernel[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by {label}")
    runs[label] = {k: round(n / steps, 2) for k, n in by_kernel.items() if n}
    return wall


def states_max_abs(a, b) -> float:
    return max(max_abs(x, y) for x, y in zip((*a["v"], *a["U"], a["p"], a["phalf"]),
                                             (*b["v"], *b["U"], b["p"], b["phalf"])))


def state_copy(state):
    return {k: (tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone())
            for k, v in state.items()}


def cylinder_regression(smi, entries, dtype, runs):
    """BASELINE #3 on the card in ``dtype``, gated as tests/test_shedding.py."""
    name = DTYPE_NAMES[dtype]
    ns, ibm = ibm_solver(setup_cylinder_2d, CYLINDER, dtype, CYLINDER_CKPT)
    if not abs(ns.t - 30.0) < 0.01:
        raise AssertionError(f"cylinder checkpoint at t={ns.t}, expected 30")
    check_solver_stencils(entries, f"cylinder 176x88 {name}", ns)
    ts, cl = [], []

    def drive():
        for _ in range(64):
            ns.advance(5)
            ts.append(ns.t)
            cl.append(drag_lift_coefficients(ns, ibm, U_in=1.0, diameter=0.1)[1])

    wall = counted(f"cylinder 176x88 {name}", drive, 320, KERNELS_2D, runs)
    assert_finite(ns, f"cylinder {name}")
    st, amp = strouhal(ts, cl)
    print(f"[ibm] cylinder 176x88 {name}: from t=30.005, 64 x advance(5) in {wall:.2f} s, "
          f"{320 / wall:.2f} steps/s (with 64 C_L reads); St {st:.4f} (gate {ST_REF} "
          f"+-{ST_TOL:.0%}), C_L amplitude {amp:.4f} (gate {AMP_RANGE}); "
          f"{sum(runs[f'cylinder 176x88 {name}'].values()):.0f} stencil launches per step; "
          f"{smi}", flush=True)
    if not abs(st - ST_REF) < ST_TOL * ST_REF:
        raise AssertionError(f"cylinder {name}: St {st} outside {ST_REF} +- {ST_TOL:.0%}")
    if not AMP_RANGE[0] < amp < AMP_RANGE[1]:
        raise AssertionError(f"cylinder {name}: C_L amplitude {amp} outside {AMP_RANGE}")


def sphere_regression(smi, entries, dtype, runs):
    """BASELINE #4 at its CI size in ``dtype``, gated as tests/test_sphere.py."""
    name = DTYPE_NAMES[dtype]
    ns, ibm = ibm_solver(setup_sphere_3d, SPHERE48, dtype, SPHERE48_CKPT)
    if not abs(ns.t - 25.0) < 0.05:
        raise AssertionError(f"sphere checkpoint at t={ns.t}, expected 25")
    check_chain_solver(entries, f"sphere 48x32x32 {name}", ns)
    check_solver_stencils(entries, f"sphere 48x32x32 {name}", ns)
    cd0 = drag_coefficient(ns, ibm, 1.0, 0.5)
    wall = counted(f"sphere 48x32x32 {name}", lambda: ns.advance(25), 25, KERNELS_3D, runs)
    cd1 = drag_coefficient(ns, ibm, 1.0, 0.5)
    assert_finite(ns, f"sphere 48 {name}")
    print(f"[ibm] sphere 48x32x32 {name}: advance(25) from t=25.02 in {wall:.2f} s, "
          f"{25 / wall:.2f} steps/s; cd {cd0:.5f} -> {cd1:.5f} (drift gate {CD_DRIFT}, "
          f"{CD48_REF} +-{CD48_TOL:.0%}); "
          f"{sum(runs[f'sphere 48x32x32 {name}'].values()):.0f} stencil launches per step; "
          f"{smi}", flush=True)
    if not abs(cd1 - cd0) < CD_DRIFT:
        raise AssertionError(f"sphere {name}: cd drifted {cd0} -> {cd1}")
    if not abs(cd1 - CD48_REF) < CD48_TOL * CD48_REF:
        raise AssertionError(f"sphere {name}: cd {cd1} outside {CD48_REF} +- {CD48_TOL:.0%}")


def bfs_run(smi, entries, runs):
    """The backward-facing step at 512x64 on the card, float64 and float32:
    its solver's kernels held against their plain versions, a step, and a
    counted advance(20) under tests/test_bfs.py's gates."""
    vel = {}
    for dtype in (torch.float64, torch.float32):
        name = DTYPE_NAMES[dtype]
        label = f"bfs 512x64 {name}"
        ns = setup_bfs_2d(**BFS, dtype=dtype, device="cuda")
        check_solver_stencils(entries, label, ns)
        ns.step()
        wall = counted(label, lambda: ns.advance(20), 20, KERNELS_2D, runs)
        assert_finite(ns, label)
        Ux = ns.state["U"][0].to("cpu", torch.float64).numpy()
        y, wy = np.asarray(ns.mesh.centers(1)), np.asarray(ns.mesh.widths(1))
        flux_in, flux_out = float((Ux[0] * wy).sum()), float((Ux[-1] * wy).sum())
        below, above = np.abs(Ux[0][y < 0.5]).max(), Ux[0][y > 0.5].max()
        vel[dtype] = [x.to("cpu", torch.float64) for x in ns.state["v"]]
        print(f"[ibm] {label}: step + advance(20) to t={ns.t:.2f}, {20 / wall:.2f} steps/s; "
              f"inlet flux {flux_in:.9f}, outlet {flux_out:.9f} (gate {BFS_FLUX_TOL}); "
              f"inlet below the step max |U| {below:.3e}, peak above {above:.4f}; "
              f"x_r/S {reattachment_length(ns) / 0.5:.4f}; "
              f"{sum(runs[label].values()):.0f} stencil launches per step; {smi}", flush=True)
        if not abs(flux_out - flux_in) < BFS_FLUX_TOL * max(abs(flux_in), 1.0):
            raise AssertionError(f"{label}: outlet flux {flux_out}, inlet {flux_in}")
        if not (below < 1e-12 and above > 1.0):
            raise AssertionError(f"{label}: inlet profile {below} below, {above} above")
    dist = max(max_abs(a, b) for a, b in zip(vel[torch.float32], vel[torch.float64]))
    print(f"[ibm] bfs 512x64: float32 velocity against float64: max abs {dist:.3e} "
          f"(gate {BFS_F32_VS_F64})", flush=True)
    if not dist < BFS_F32_VS_F64:
        raise AssertionError(f"bfs 512x64: float32 parts from float64 by {dist}")


def flip_byte_refused(ck, tmp):
    """A copy of checkpoint ``ck`` with one payload byte of p.bin flipped
    must be refused on load (its CRC)."""
    bad = os.path.join(tmp, "flipped")
    shutil.copytree(ck, bad)
    path = Path(bad, "p.bin")
    raw = bytearray(path.read_bytes())
    raw[24 + len(raw) // 3] ^= 0x10
    path.write_bytes(bytes(raw))
    ns, _ = ibm_solver(setup_cylinder_2d, CYLINDER, torch.float32)
    try:
        load_checkpoint(bad, ns)
    except IOError as e:
        return str(e)
    raise AssertionError("a checkpoint with a flipped payload byte was loaded")


def sphere128(smi, entries, runs, tmp):
    """BASELINE #4 at full width, float32: one step, advance(20), and the
    restart at size at max abs 0."""
    torch.cuda.reset_peak_memory_stats()
    ns, ibm = ibm_solver(setup_sphere_3d, SPHERE128, torch.float32)
    check_chain_solver(entries, "sphere 128^3 f32", ns)
    check_solver_stencils(entries, "sphere 128^3 f32", ns)
    t0 = time.perf_counter()
    ns.step()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    wall = counted("sphere 128^3 f32", lambda: ns.advance(20), 20, KERNELS_3D, runs)
    assert_finite(ns, "sphere 128^3")
    cd = drag_coefficient(ns, ibm, 1.0, 0.5)
    rnorm = float(ns.last_diag["ksp_rnorm"])
    if not (np.isfinite(cd) and np.isfinite(rnorm)):
        raise AssertionError(f"sphere 128^3: cd {cd}, ksp_rnorm {rnorm}")
    mem = torch.cuda.max_memory_allocated()
    ck = os.path.join(tmp, "sphere128")
    t1 = time.perf_counter()
    save_checkpoint(ck, ns)
    ns2, _ = ibm_solver(setup_sphere_3d, SPHERE128, torch.float32, ck)
    io_s = time.perf_counter() - t1
    ns.advance(5)
    ns2.advance(5)
    dist = states_max_abs(ns.state, ns2.state)
    print(f"[ibm] sphere 128^3 f32 ({ibm.markers.X.shape[0]} markers): first step "
          f"{first:.2f} s, advance(20) in {wall:.2f} s, {20 / wall:.2f} steps/s; cd "
          f"{cd:.5f} at t={ns.t - 5 * ns.dt:.3f}, ksp_rnorm {rnorm:.4g}; peak memory "
          f"{mem / 2**30:.3f} GiB; "
          f"{sum(runs['sphere 128^3 f32'].values()):.0f} stencil launches per step; "
          f"checkpoint save + load {io_s:.2f} s; restart + advance(5) against the run "
          f"continued: max abs {dist:.3e}; {smi}", flush=True)
    if dist != 0.0:
        raise AssertionError(f"sphere 128^3: restart parts from the run by {dist}")
    return {"steps_per_s": 20 / wall, "max_memory_bytes": mem,
            "markers": int(ibm.markers.X.shape[0])}


def cylinder4096(smi, entries, runs):
    """The benchmark's 2-D cylinder wake at its size, float32: the 2-D
    kernels in every mode on every multigrid level, and the momentum
    kernel on the step's coefficients, against their plain versions; then
    one counted step, whose launch keys phase_ledger finds checked."""
    torch.cuda.reset_peak_memory_stats()
    ns, ibm = ibm_solver(setup_cylinder_2d, CYLINDER4096, torch.float32)
    label = "cylinder 4096x2048 f32"
    check_solver_stencils(entries, label, ns)
    wall = counted(label, ns.step, 1, KERNELS_2D, runs)
    assert_finite(ns, label)
    mem = torch.cuda.max_memory_allocated()
    print(f"[ibm] {label} ({ibm.markers.X.shape[0]} markers, "
          f"{len(ns.impl.mg.levels)} multigrid levels): first step {wall:.2f} s, "
          f"{sum(runs[label].values()):.0f} stencil launches; peak memory "
          f"{mem / 2**30:.3f} GiB; {smi}", flush=True)


def cylinder_restart(tmp):
    """float32 cylinder from t = 30: advance(20) equals advance(10), save,
    load into a fresh solver, advance(10), at max abs 0; two fresh runs
    of the same 10 steps are equal at max abs 0; a spread with one
    marker's weight zeroed must part from them."""
    a, _ = ibm_solver(setup_cylinder_2d, CYLINDER, torch.float32, CYLINDER_CKPT)
    a.advance(20)
    b, _ = ibm_solver(setup_cylinder_2d, CYLINDER, torch.float32, CYLINDER_CKPT)
    b.advance(10)
    b10 = state_copy(b.state)
    ck = os.path.join(tmp, "cylinder")
    save_checkpoint(ck, b)
    c, _ = ibm_solver(setup_cylinder_2d, CYLINDER, torch.float32, ck)
    c.advance(10)
    restart = states_max_abs(a.state, c.state)
    d, _ = ibm_solver(setup_cylinder_2d, CYLINDER, torch.float32, CYLINDER_CKPT)
    d.advance(10)
    rerun = states_max_abs(b10, d.state)
    e, e_ibm = ibm_solver(setup_cylinder_2d, CYLINDER, torch.float32, CYLINDER_CKPT)
    e_ibm.markers.ds[0] = 0.0  # the planted fault: marker 0 spreads nothing
    e.advance(10)
    fault = states_max_abs(e.state, d.state)
    refused = flip_byte_refused(ck, tmp)
    print(f"[ibm] cylinder f32 restart: advance(20) vs advance(10) + save + load + "
          f"advance(10): max abs {restart:.3e}; two fresh runs of 10 steps: max abs "
          f"{rerun:.3e}; planted fault (marker 0's weight zeroed in the spread): max abs "
          f"{fault:.3e}; planted fault (a payload byte flipped): refused ({refused})",
          flush=True)
    if restart != 0.0 or rerun != 0.0:
        raise AssertionError(f"cylinder restart {restart}, rerun {rerun}: expected 0")
    if not fault > rerun:
        raise AssertionError("the zeroed marker weight did not move the forced step")


def phase_ibm(smi, entries):
    """BASELINE #3 and #4 on the card from the committed checkpoints, in
    float64 and float32; the backward-facing step; the 128^3 sphere;
    restarts, determinism and two planted faults; the 4096x2048 cylinder. Returns the runs' launches per step and the 128^3
    sphere's figures."""
    t0 = time.perf_counter()
    runs = {}
    for dtype in (torch.float64, torch.float32):
        cylinder_regression(smi, entries, dtype, runs)
        sphere_regression(smi, entries, dtype, runs)
    bfs_run(smi, entries, runs)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        big = sphere128(smi, entries, runs, tmp)
        cylinder_restart(tmp)
    cylinder4096(smi, entries, runs)
    print(f"[ibm] all IBM runs passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, big


# ----------------------------------------------------------------------
# the reference's accuracy contract, the turbulent channel, the FD layer
# ----------------------------------------------------------------------

# tolerance.py's first row: the 128^3 wall-clustered channel at the
# bench's dt (convective CFL ~ 5.8), float32, under the reference's own
# solver (FGMRES rtol 1e-5, BiCGStab and CG+MG at 1e-5)
TOL_CHANNEL = dict(N=(128, 128, 128), stretch_y=2.0, dt=2e-3, max_steps=10**9)
TOL_STEPS = 3
TOL_RTOL = 1e-5
# the reference's TPU record of production() on this row's first step
# (TOLERANCE.json, production_o3m8s6_128_cfl5.8): printed beside the
# card's, not a gate
TPU_PRODUCTION_RTOL = 3.39e-02
CHAIN_STAGES = ("chain3d_coupled", "chain3d_pre", "chain3d_post")
# CHANNEL_TURB.json's channel: 64^3 from the rolls, Re_tau 180, dt 4e-4,
# float32 production(), through channel_turb's loop and guards
TURB_N, TURB_DT, TURB_STEPS, TURB_CHUNK = 64, 4e-4, 200, 50


def achieved_rtol(diag) -> float:
    return float(diag["ksp_rnorm"]) / max(float(diag["rhs_norm"]), 1e-30)


def phase_tolerance(smi, entries, runs):
    """The reference's stopping rule on the card: tolerance.py's first
    row (TOL_CHANNEL), TOL_STEPS steps cold and TOL_STEPS warm-started
    (CNLinearConfig.warm_start), each run with the launch counts at 0;
    every step converged with ksp_rnorm <= TOL_RTOL ||rhs|| and finite
    fields. Then one production() step on the cold run's state, its
    effective rtol printed beside the reference's TPU record. The
    solver's stencils and chain are held against their plain versions
    first."""
    t_start = time.perf_counter()
    iters = {}
    ns = None
    for warm in (False, True):
        ns = setup_channel_3d(dtype=torch.float32, device="cuda", **TOL_CHANNEL)
        ns.impl.cfg = CNLinearConfig(warm_start=warm, diag_rhs_norm=True)
        label = f"tolerance 128^3 {'warm' if warm else 'cold'}"
        if not warm:
            check_solver_stencils(entries, label, ns)
            check_chain_solver(entries, label, ns)
        steps = []

        def run(ns=ns, steps=steps):
            for _ in range(TOL_STEPS):
                t0 = time.perf_counter()
                ns.step()
                d = ns.last_diag
                steps.append((int(d["ksp_iters"]), achieved_rtol(d), bool(d["converged"]),
                              time.perf_counter() - t0))

        wall = counted(label, run, TOL_STEPS, ("poisson3d", "momentum3d", *CHAIN_STAGES), runs)
        assert_finite(ns, label)
        for k, (its, rtol, conv, sec) in enumerate(steps):
            print(f"[tolerance] {label} step {k + 1}: {its} outer iterations, achieved rtol "
                  f"{rtol:.3e}, {sec:.2f} s", flush=True)
            if not conv or not rtol <= TOL_RTOL:
                raise AssertionError(f"{label} step {k + 1}: converged {conv}, achieved rtol "
                                     f"{rtol:.3e} (contract {TOL_RTOL})")
        if ns.step_index != TOL_STEPS:
            raise AssertionError(f"{label}: {ns.step_index} steps taken, not {TOL_STEPS}")
        iters[warm] = [x[0] for x in steps]
        print(f"[tolerance] {label}: {TOL_STEPS} steps in {wall:.2f} s "
              f"({wall / TOL_STEPS:.2f} s per step); launches per step {runs[label]}; "
              f"{smi}", flush=True)
    print(f"[tolerance] outer iterations cold {iters[False]} against warm {iters[True]}",
          flush=True)
    cfg = CNLinearConfig.production()
    cfg.diag_rhs_norm = True
    ns.impl.cfg = cfg
    ns.step()
    rtol = achieved_rtol(ns.last_diag)
    assert_finite(ns, "tolerance 128^3 production step")
    print(f"[tolerance] one production() step on the warm run's state: effective rtol "
          f"{rtol:.3e} (the reference's TPU record, this row's first step: "
          f"{TPU_PRODUCTION_RTOL:.2e}); phase {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return {"cold": iters[False], "warm": iters[True], "production_rtol": rtol}


def phase_turb(smi, entries, runs):
    """The turbulent channel of CHANNEL_TURB.json on the card: 64^3 from
    the rolls, TURB_STEPS steps through channel_turb.run with its guards
    (DIVERGED, the two collapses), the counts at 0 just before; no guard
    may trip, E_turb and u_tau finite. Prints turb_stats after each chunk
    and at the end."""
    t0 = time.perf_counter()
    ns = channel_turb.setup(TURB_N, TURB_DT, device="cuda")
    label = f"channel {TURB_N}^3 rolls"
    check_solver_stencils(entries, label, ns)
    check_chain_solver(entries, label, ns)
    out = {}

    def run():
        out["run"] = channel_turb.run(ns, TURB_STEPS, TURB_CHUNK, 0.0,
                                      log=lambda line: print(f"[turb] {line}", flush=True))

    wall = counted(label, run, TURB_STEPS + 1, ("poisson3d", "momentum3d", *CHAIN_STAGES),
                   runs)
    series, _, _, stop = out["run"]
    if stop is not None:
        raise AssertionError(f"{label}: the guard tripped: {stop}")
    E, u_tau, profs = channel_turb.turb_stats(ns)
    if not (np.isfinite(E) and np.isfinite(u_tau)):
        raise AssertionError(f"{label}: E_turb {E}, u_tau {u_tau}")
    assert_finite(ns, label)
    print(f"[turb] {label}: {TURB_STEPS + 1} steps to t = {ns.t:.4f} in {wall:.2f} s "
          f"({(TURB_STEPS + 1) / wall:.1f} steps/s, one host read per chunk); turb_stats: "
          f"E_turb {E:.6e}, u_tau {u_tau:.6f}, centreline U {float(profs['U'].max()):.4f}, "
          f"min <u'v'> {float(profs['uv'].min()):.4e}, max <u'u'> "
          f"{float(profs['uu'].max()):.4e}; launches per step {runs[label]}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"t": ns.t, "E_turb": E, "u_tau": u_tau, "series": series}


def ex1_bound() -> float:
    """ex1's float64 bound: its BiCGStab stops at rtol 1e-10, so two runs
    that sum in another order part by up to twice the solve's own
    guarantee, cond(A) * 1e-10 (on the CPU fluca_tpu's and the port's
    part by 2e-8): the condition number of ex1's system, assembled on
    the host."""
    m = CartMesh.create((64,))
    m.set_uniform_coordinates(0.0, 1.0)
    bcs = [fd_ops.FDBC(fd_ops.FDBCType.DIRICHLET, 0.0), fd_ops.FDBC(fd_ops.FDBCType.DIRICHLET, 1.0)]
    A = (fd_ops.derivative(m, 0, 1, 2, bcs=bcs).to_dense()
         - 0.05 * fd_ops.derivative(m, 0, 2, 2, bcs=bcs).to_dense())
    return 2 * float(np.linalg.cond(A)) * 1e-10


FD_N = 256
FD_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def fd_laplacian(N):
    """The 3-D Laplacian of the FD layer on the unit cube at N^3: the
    sum over the axes of the second derivative composed of two first
    derivatives, periodic axis 0, DIRICHLET walls on axis 1 (values 1
    and -0.5) and NEUMANN on axis 2 (0.25 and -0.75)."""
    m = CartMesh.create((N, N, N), (True, False, False))
    m.set_uniform_coordinates(0, 1, 0, 1, 0, 1)
    B, K = fd_ops.FDBC, fd_ops.FDBCType
    bcs = [B(), B(), B(K.DIRICHLET, 1.0), B(K.DIRICHLET, -0.5), B(K.NEUMANN, 0.25),
           B(K.NEUMANN, -0.75)]
    return fd_ops.fd_sum(*(fd_ops.fd_compose(fd_ops.derivative(m, d, 1, 2, bcs=bcs),
                                             fd_ops.derivative(m, d, 1, 2, bcs=bcs))
                           for d in range(3)))


def phase_fd():
    """The FD layer on the card (torch ops; no kernel of its own): the
    tutorials ex1-ex4 in float64 and float32 against the same calls on
    the CPU in float64 (rel norm FD_RTOL; ex1 in float64 at its solve's
    bound, ex1_bound), each tutorial's own physics checks passing on the
    card; then the 3-D Laplacian (fd_laplacian) at FD_N^3 applied in
    float32 on the card against its float64 apply on the CPU, within
    FD_RTOL[float32], and its time."""
    t0 = time.perf_counter()
    bounds = {torch.float64: FD_RTOL[torch.float64], torch.float32: FD_RTOL[torch.float32]}
    for name, fn in fd_tutorials.TUTORIALS.items():
        ref = fn(device="cpu", dtype=torch.float64)
        for dtype in (torch.float64, torch.float32):
            got = fn(device="cuda", dtype=dtype)
            bound = ex1_bound() if (name, dtype) == ("ex1", torch.float64) else bounds[dtype]
            r = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
            print(f"[fd] {name} {DTYPE_NAMES[dtype]} on the card against float64 on the CPU: "
                  f"rel {r:.3e} (bound {bound:.1e})", flush=True)
            if not r <= bound:
                raise AssertionError(f"fd tutorial {name} {dtype}: rel {r:.3e} > {bound:.1e}")
    t1 = time.perf_counter()
    lap = fd_laplacian(FD_N)
    t2 = time.perf_counter()
    x = np.random.default_rng(21).standard_normal((FD_N,) * 3)
    ref = lap.apply(torch.from_numpy(x))
    t3 = time.perf_counter()
    xc = torch.from_numpy(x).to("cuda", torch.float32)
    got = lap.apply(xc)
    torch.cuda.synchronize()
    r = rel_err(got.cpu(), ref)
    ms = cuda_ms(lambda: lap.apply(xc), iters=20, warmup=3)
    print(f"[fd] 3-D Laplacian at {FD_N}^3 ({len(lap.bands)} bands; periodic x, Dirichlet y, "
          f"Neumann z), float32 on the card against float64 on the CPU: rel {r:.3e} (bound "
          f"{FD_RTOL[torch.float32]:.0e}); {ms:.3f} ms per apply on the card (torch ops); "
          f"built on the host in {t2 - t1:.1f} s, applied on the CPU in {t3 - t2:.1f} s; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    if not r <= FD_RTOL[torch.float32]:
        raise AssertionError(f"fd Laplacian {FD_N}^3: rel {r:.3e}")
    return {"laplacian_ms": ms, "laplacian_rel": r}


# ----------------------------------------------------------------------
# the domain-decomposed step
# ----------------------------------------------------------------------

HALO = {"poisson2d": cuda_stencil.poisson2d_halo, "momentum2d": cuda_stencil.momentum2d_halo,
        "poisson3d": cuda_stencil.poisson3d_halo, "momentum3d": cuda_stencil.momentum3d_halo}
HALO_PLAIN = {"poisson2d": cuda_stencil.poisson2d_halo_plain,
              "poisson3d": cuda_stencil.poisson3d_halo_plain}
# The function that builds each halo instance's TPU counterpart
# (fluca_tpu/parallel/pallas_sharded.py).
HALO_REPLACES = {"poisson2d": 71, "momentum2d": 181, "poisson3d": 71, "momentum3d": 256}
# The sharded run against the unsharded unchained run of the same steps,
# as ||a - b|| / ||b|| over v, over U and over p, float32. The halo
# kernels do the unsharded kernels' arithmetic in the same order and the
# rest of the step runs on the global tensors as it is, so the two runs
# should agree bit for bit (predicted: 0); a wrong edge plane gives
# O(1e-3) or more after one step.
SHARDED_RTOL = 1e-6


def hold_halo(entries, name, label, dtype, got, plain, unsharded):
    """The halo instance's outputs ``got`` against its plain version's
    ``plain`` (KERNEL_RTOL; marks its ledger key) and against the
    unsharded kernel's ``unsharded`` on the global field: max abs
    difference 0."""
    e = entries[name + "_halo"]
    check_kernel(e, f"{name}_halo {label}", dtype, got, plain, HALO[name])
    d = max(max_abs(a, b) for a, b in zip(got, unsharded))
    e["max_abs_vs_unsharded"] = max(e["max_abs_vs_unsharded"], d)
    e["checks"] += 1
    if d != 0.0:
        raise AssertionError(f"{name}_halo {label} {dtype}: differs from the unsharded "
                             f"kernel by {d:.3e} (max abs)")


def coeffs_as(c, dtype):
    """A Poisson coefficient set in ``dtype``."""
    if len(c.shape) == 2:
        return cuda_stencil.Poisson2DCoeffs(c.rx.to(dtype), c.ry.to(dtype), c.cy.to(dtype),
                                            c.cyb.to(dtype), c.periodic)
    return cuda_stencil.Poisson3DCoeffs(*(x.to(dtype) for x in (c.a0, c.c1, c.c2, c.h0,
                                                                c.h1, c.h2)), c.periodic)


def check_poisson_halo(entries, label, grid, mesh, coeffs, inv_diag, rng):
    """The three modes of the halo instance under ``grid`` on one level's
    coefficients, fields in ``inv_diag``'s dtype, against its plain
    version and the unsharded kernel (itself held against its plain
    version); returns the number of checks."""
    name = "poisson2d" if mesh.dim == 2 else "poisson3d"
    kernel, plain = getattr(cuda_stencil, name), getattr(cuda_stencil, name + "_plain")
    dtype = inv_diag.dtype
    layout = halo_layout(grid, mesh)
    p, b = (torch.as_tensor(rng.standard_normal(mesh.N), dtype=dtype, device="cuda")
            for _ in range(2))
    edges = field_edges(layout, p)
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, inv_diag, 0.8)}[mode]
        got = HALO[name](mode, p, coeffs, layout, edges, *args)
        ref = HALO_PLAIN[name](mode, p, coeffs, layout, edges, *args)
        uns = kernel(mode, p, coeffs, *args)
        uref = plain(mode, p, coeffs, *args)
        torch.cuda.synchronize()
        tag = f"{mode} {label} {mesh.N} on {grid.shape}"
        check_kernel(entries[name], f"{name} {tag}", dtype, (uns,), (uref,), kernel)
        hold_halo(entries, name, tag, dtype, (got,), (ref,), (uns,))
    return len(cuda_stencil.POISSON_MODES)


def check_momentum2d_halo(entries, label, grid, mesh, W, rng):
    """The 2-D momentum halo instance under ``grid`` on the plane stack W."""
    dtype = W.dtype
    layout = halo_layout(grid, mesh)
    u, v = (torch.as_tensor(rng.standard_normal(mesh.N), dtype=dtype, device="cuda")
            for _ in range(2))
    ue, ve = field_edges(layout, u), field_edges(layout, v)
    got = cuda_stencil.momentum2d_halo(W, u, v, layout, ue, ve)
    ref = cuda_stencil.momentum2d_halo_plain(W, u, v, layout, ue, ve)
    uns = cuda_stencil.momentum2d(W, u, v, mesh.periodic)
    uref = cuda_stencil.momentum2d_plain(W, u, v, mesh.periodic)
    torch.cuda.synchronize()
    tag = f"{label} {mesh.N} on {grid.shape}"
    check_kernel(entries["momentum2d"], f"momentum2d {tag}", dtype, uns, uref,
                 cuda_stencil.momentum2d)
    hold_halo(entries, "momentum2d", tag, dtype, got, ref, uns)
    return 1


def check_momentum3d_halo(entries, label, sm, U0, v0f, rng):
    """The 3-D momentum halo instance of the sharded apply ``sm``
    (parallel/sharded.py) on the factors of (U0, v0f) in its dtype."""
    bands = sm.bands
    dtype = bands.b[0].dtype
    prepped = sm.prep(U0, v0f)
    v = tuple(torch.as_tensor(rng.standard_normal(sm.layout.shape), dtype=dtype,
                              device="cuda") for _ in range(3))
    ve = tuple(field_edges(sm.layout, x) for x in v)
    f = prepped.factors
    got = cuda_stencil.momentum3d_halo(bands, f, v, sm.layout, ve, prepped.face_hi)
    ref = cuda_stencil.momentum3d_halo_plain(bands, f, v, sm.layout, ve, prepped.face_hi)
    uns = cuda_stencil.momentum3d(bands, f, v)
    uref = cuda_stencil.momentum3d_plain(bands, f, v)
    torch.cuda.synchronize()
    tag = f"{label} {sm.layout.shape} on {sm.layout.grid.shape}"
    check_kernel(entries["momentum3d"], f"momentum3d {tag}", dtype, uns, uref,
                 cuda_stencil.momentum3d)
    hold_halo(entries, "momentum3d", tag, dtype, got, ref, uns)
    return 1


def check_halo_combos(entries):
    """Each halo instance, float32 and float64, on every periodic/wall
    combination the reference tests (tests/test_pallas_sharded.py:41-42,
    75-76, 122-123, 187-188), at its sizes: Poisson 32^2 on (4, 2) and
    16^3 on (2, 2, 2), momentum 32^2 on (2, 4) and (4, 2) at random face
    factors on a non-uniform grid, momentum (16, 16, 256) on (2, 2, 2)."""
    rng = np.random.default_rng(20)
    n = 0

    def mesh_of(N, periodic):
        m = CartMesh.create(N, periodic)
        m.set_coordinates(*[(lambda f: f + 0.15 * (f - f**2))(np.linspace(0.0, 1.0, k + 1))
                            for k in N])
        return m

    def bcs_of(periodic):
        return [BoundaryCondition(BCType.PERIODIC) if per else zero_velocity_bc()
                for per in periodic for _ in range(2)]

    def rand(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

    for dtype in (torch.float32, torch.float64):
        for N, grid_shape, combos in (((32, 32), (4, 2), ((False, False), (True, True),
                                                            (True, False))),
                                      ((16, 16, 16), (2, 2, 2), ((True, False, True),
                                                                 (False, False, False)))):
            for per in combos:
                mesh = mesh_of(N, per)
                lvl = mg_mod.PoissonMG(mesh, bcs_of(per), scale=1.0, dtype=dtype,
                                       device="cuda").levels[0]
                n += check_poisson_halo(entries, f"periodic={per}",
                                        make_device_grid(len(N), shape=grid_shape), mesh,
                                        lvl.coeffs, lvl.inv_diag, rng)
        for per in ((False, False), (True, False), (True, True)):
            mesh = mesh_of((32, 32), per)
            ops = NSOperators(mesh, bcs_of(per), 1.3, 0.02, 0.01, dtype, "cuda")
            W = ops.build_momentum_coeffs_stacked(
                tuple(rand(mesh.face_shape(d), dtype) for d in range(2)),
                tuple(tuple(rand(mesh.face_shape(d), dtype) for _ in range(2))
                      for d in range(2)))
            for shape in ((2, 4), (4, 2)):
                n += check_momentum2d_halo(entries, f"periodic={per}",
                                           make_device_grid(2, shape=shape), mesh, W, rng)
        for per in ((True, False, True), (False, False, False)):
            mesh = mesh_of((16, 16, 256), per)
            sm = build_momentum_sharded(make_device_grid(3, shape=(2, 2, 2)), mesh,
                                        T_.axis_bcs(mesh, bcs_of(per)), 1.3, 0.02, 0.01,
                                        dtype)
            n += check_momentum3d_halo(
                entries, f"periodic={per}", sm,
                tuple(rand(mesh.face_shape(d), dtype) for d in range(3)),
                tuple(tuple(rand(mesh.face_shape(d), dtype) for _ in range(3))
                      for d in range(3)), rng)
    print(f"[sharded] {n} halo checks on every periodic/wall combination of the "
          f"reference's tests, float32 and float64", flush=True)


def check_sharded_solver(entries, label, ns, dtypes=None):
    """The halo instances at the shapes of the sharded solver of ``ns``:
    the Poisson modes on every level that runs sharded and the momentum
    kernel on the current step's coefficients, in ``dtypes`` (the
    solver's if None), each against its plain version and the unsharded
    kernel."""
    impl, ops, grid = ns.impl, ns.impl.ops, ns.device_grid
    rng = np.random.default_rng(21)
    v0f = step_v0f(ops, ns.state, ns.t)
    n = 0
    for dtype in dtypes or (impl.dtype,):
        for lvl in impl.mg.levels:
            if lvl.sharded:
                n += check_poisson_halo(entries, label, grid, lvl.mesh,
                                        coeffs_as(lvl.coeffs, dtype),
                                        lvl.inv_diag.to(dtype), rng)
        if ns.mesh.dim == 2:
            W = ops.build_momentum_coeffs_stacked(ns.state["U"], v0f).to(dtype)
            n += check_momentum2d_halo(entries, label, grid, ns.mesh, W, rng)
        else:
            sm = ops.sharded_momentum if dtype == impl.dtype else build_momentum_sharded(
                grid, ns.mesh, ops.axbcs, impl.rho, impl.mu, impl.dt, dtype)
            n += check_momentum3d_halo(entries, label, sm, ns.state["U"], v0f, rng)
    print(f"[sharded] {label}: {n} halo checks on the sharded solver's levels "
          f"{impl.mg.sharded_levels} and coefficients", flush=True)


def planted_halo_faults(ns):
    """Zero one edge plane of one shard, on the periodic x axis (shard 0's
    wrap plane from the last shard) and on the wall-normal y axis (shard
    0's plane from shard 1), and run the Poisson 3-D halo instance on the
    finest level of the sharded channel: both comparisons, against the
    plain version and against the unsharded kernel, must catch each."""
    grid, lvl = ns.device_grid, ns.impl.mg.levels[0]
    layout = halo_layout(grid, lvl.mesh)
    p = torch.randn(lvl.mesh.N, generator=torch.Generator(device="cuda").manual_seed(22),
                    device="cuda")
    edges = field_edges(layout, p)
    ref = cuda_stencil.poisson3d_halo_plain("apply", p, lvl.coeffs, layout, edges)
    uns = cuda_stencil.poisson3d("apply", p, lvl.coeffs)
    for axis, side, what in ((0, 0, "periodic x, shard 0's lo plane (the wrap)"),
                             (1, 1, "wall-normal y, shard 0's hi plane")):
        bad = [None if e is None else [t.clone() for t in e] for e in edges]
        bad[axis][side].select(axis, 0).zero_()
        got = cuda_stencil.poisson3d_halo("apply", p, lvl.coeffs, layout, bad)
        torch.cuda.synchronize()
        errs = (rel_err(got, ref), rel_err(got, uns))
        print(f"[sharded] planted fault ({what} zeroed): rel err {errs[0]:.4e} against "
              f"the plain version, {errs[1]:.4e} and max abs {max_abs(got, uns):.4e} "
              f"against the unsharded kernel", flush=True)
        if not (errs[0] > KERNEL_RTOL[torch.float32] and errs[1] > KERNEL_RTOL[torch.float32]
                and max_abs(got, uns) > 0.0):
            raise AssertionError(f"the planted fault ({what}) passed: {errs}")


def sharded_run(make, grid_shape, nsteps, label, smi, entries, unsharded_state,
                profile=False):
    """``make()``'s solver sharded on ``grid_shape``: its halo instances
    checked at its shapes (float32 and float64), one step + advance(nsteps
    - 1) timed, and its state against ``unsharded_state`` (SHARDED_RTOL);
    ``profile``: then a torch.profiler breakdown of 3 more steps. Returns
    (ns, launches, mean |u| before the run)."""
    ns = make()
    u0 = float(ns.state["v"][0].abs().mean())
    ns.shard(shape=grid_shape)
    if not isinstance(ns.impl._stages, UnfusedChain) or ns.impl._pre_resources() is not None:
        raise AssertionError(f"{label}: the sharded solver must run UnfusedChain, bf16 off")
    check_sharded_solver(entries, label, ns, (torch.float32, torch.float64))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first, adv, launches = timed_run(ns, nsteps - 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(ns.last_diag["converged"]):
        raise AssertionError(f"{label}: step {ns.step_index} did not converge")
    assert_finite(ns, label)
    names = ("poisson3d_halo", "momentum3d_halo") if ns.mesh.dim == 3 else (
        "poisson2d_halo", "momentum2d_halo")
    require_launches(launches, names, label)
    st, ref = ns.state, unsharded_state
    errs = {"v": vec_rel_err(st["v"], ref["v"]), "U": vec_rel_err(st["U"], ref["U"]),
            "p": rel_err(st["p"], ref["p"])}
    diffs = {"v": max(max_abs(a, b) for a, b in zip(st["v"], ref["v"])),
             "U": max(max_abs(a, b) for a, b in zip(st["U"], ref["U"])),
             "p": max_abs(st["p"], ref["p"])}
    print(f"[sharded] {label} on {grid_shape}: first step {first * 1e3:.2f} ms, "
          f"advance({nsteps - 1}) {adv * 1e3:.2f} ms = {(nsteps - 1) / adv:.4f} steps/s "
          f"({smi}); ksp_rnorm {float(ns.last_diag['ksp_rnorm']):.4g}; peak memory "
          f"{peak:.2f} GiB; levels sharded {ns.impl.mg.sharded_levels}; launches per step "
          f"{per_step(launches, nsteps)}", flush=True)
    print(f"[sharded] {label}, sharded vs unsharded unchained after {nsteps} steps: "
          + ", ".join(f"{k} rel {errs[k]:.4e} max abs {diffs[k]:.4e}" for k in errs)
          + f" (gate rel <= {SHARDED_RTOL:g}; predicted 0)", flush=True)
    for k, e in errs.items():
        if not e <= SHARDED_RTOL:
            raise AssertionError(f"{label}: sharded vs unsharded {k} rel {e:.4e}")
    if profile:
        phase_profile(f"{label}, sharded on {grid_shape}", ns)
    return ns, launches, u0


def unsharded_run(make, nsteps, label, smi, profile=False):
    """``make()``'s solver unchained (UnfusedChain, as the sharded step
    runs), one step + advance(nsteps - 1); returns its state (taken before
    the profiled steps where ``profile``)."""
    ns = make()
    unchain(ns)
    first, adv, _ = timed_run(ns, nsteps - 1)
    assert_finite(ns, label)
    print(f"[sharded] {label} unsharded, unchained: first step {first * 1e3:.2f} ms, "
          f"advance({nsteps - 1}) {adv * 1e3:.2f} ms = {(nsteps - 1) / adv:.4f} steps/s "
          f"({smi})", flush=True)
    state = ns.state
    if profile:
        phase_profile(f"{label}, unsharded unchained", ns)
    return state


def time_halo(label, call, kernels_only, unsharded, plain, nbytes_moved, flops, reps,
              plain_eager=False):
    """Device time (CUDA graph) of one sharded call (the edge exchange and
    one launch per shard), of its launches alone, of the unsharded kernel
    and of the plain version, beside the bound of the sharded call's work
    (the unsharded bytes plus the edge planes). ``plain_eager``: the plain
    version reads a flag back to the host, so it is timed eagerly."""
    ms = graph_ms(call, **reps)
    kernels_ms = graph_ms(kernels_only, **reps)
    unsharded_ms = graph_ms(unsharded, **reps)
    plain_ms = (cuda_ms(plain, reps["calls"] * reps["replays"]) if plain_eager
                else graph_ms(plain, **reps))
    bound_ms, bound_by = bound(nbytes_moved, flops)
    print(f"[time] {label}: sharded call {ms:.5f} ms on the device (its launches alone "
          f"{kernels_ms:.5f} ms), unsharded kernel {unsharded_ms:.5f} ms; bound "
          f"{bound_ms:.5f} ms by {bound_by} ({100 * bound_ms / ms:.1f} % of the call); "
          f"plain {plain_ms:.5f} ms{' (eager)' if plain_eager else ''}", flush=True)
    return {"ms": ms, "kernels_ms": kernels_ms, "unsharded_ms": unsharded_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def edge_bytes(edges):
    return nbytes(*(t for e in edges if e is not None for t in e))


def time_halo_solver(entries, ns, reps):
    """Each halo instance of the sharded solver of ``ns`` at its finest
    level and current step coefficients: the Poisson modes and the
    momentum apply; the apply's and the momentum's times go to
    ``entries``."""
    impl, ops, grid = ns.impl, ns.impl.ops, ns.device_grid
    lvl, mesh = impl.mg.levels[0], ns.mesh
    name = "poisson3d" if mesh.dim == 3 else "poisson2d"
    n = int(np.prod(mesh.N))
    gen = torch.Generator(device="cuda").manual_seed(23)
    p, b = (torch.randn(mesh.N, generator=gen, device="cuda") for _ in range(2))
    edges = field_edges(lvl.sharded["apply"].layout, p)
    label = f"{'x'.join(map(str, mesh.N))} on {grid.shape}"
    for mode in cuda_stencil.POISSON_MODES:
        args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag)}[mode]
        f = lvl.sharded[mode]
        t = time_halo(
            f"{name}_halo {mode} {label}", lambda: f(p, *args),
            lambda: f.launch(p, edges, *args),
            lambda: getattr(cuda_stencil, name)(mode, p, lvl.coeffs, *args, omega=0.8),
            lambda: HALO_PLAIN[name](mode, p, lvl.coeffs, f.layout, edges, *args,
                                     omega=0.8),
            nbytes(p, p, *args, *coeff_tensors(lvl.coeffs)) + edge_bytes(edges),
            n * FLOPS_PER_CELL[name][mode], reps)
        if mode == "apply":
            entries[name + "_halo"].update(t)
    del p, b, edges
    sm, v0f = ops.sharded_momentum, step_v0f(ops, ns.state, ns.t)
    v = tuple(torch.randn(mesh.N, generator=gen, device="cuda") for _ in range(mesh.dim))
    ve = tuple(field_edges(sm.layout, x) for x in v)
    if mesh.dim == 2:
        W = ops.build_momentum_coeffs_stacked(ns.state["U"], v0f)
        t = time_halo(
            f"momentum2d_halo {label} (step planes)", lambda: sm(W, *v),
            lambda: sm.launch(W, *v, *ve),
            lambda: cuda_stencil.momentum2d(W, *v, mesh.periodic),
            lambda: cuda_stencil.momentum2d_halo_plain(W, *v, sm.layout, *ve),
            nbytes(W, *v, *v) + sum(edge_bytes(e) for e in ve),
            n * FLOPS_PER_CELL["momentum2d"], reps, plain_eager=True)
        entries["momentum2d_halo"].update(t)
        return
    prepped = sm.prep(ns.state["U"], v0f)
    f = prepped.factors
    faces = [*f.U0, *(F for row in f.v0f for F in row)]
    t = time_halo(
        f"momentum3d_halo {label} (step factors)", lambda: sm.apply(v, prepped),
        lambda: sm.launch(v, prepped, ve),
        lambda: cuda_stencil.momentum3d(sm.bands, f, v),
        lambda: cuda_stencil.momentum3d_halo_plain(sm.bands, f, v, sm.layout, ve,
                                                   prepped.face_hi),
        nbytes(*sm.bands.b, *v, *faces, *v) + sum(edge_bytes(e) for e in ve)
        + edge_bytes(prepped.face_hi), n * FLOPS_PER_CELL["momentum3d"], reps,
        plain_eager=True)
    entries["momentum3d_halo"].update(t)


def time_halo_2d_large(entries, reps):
    """The 2-D halo instances at 4096^2 on (4, 2), where the device and
    not the host sets the time: the Poisson modes on a wall-bounded
    level, the momentum apply on random planes (the +-2 planes zero, as
    off the walls), each checked first."""
    rng = np.random.default_rng(24)
    mesh = unit_mesh(4096, False)
    grid = make_device_grid(2, shape=(4, 2))
    lvl = mg_mod._build_level(mesh, T_.axis_bcs(mesh, cavity_bcs()), 0.01, torch.float32,
                              "cuda")
    check_poisson_halo(entries, "4096^2", grid, mesh, lvl.coeffs, lvl.inv_diag, rng)
    p, b = (torch.as_tensor(rng.standard_normal(mesh.N), dtype=torch.float32, device="cuda")
            for _ in range(2))
    for mode in cuda_stencil.POISSON_MODES:
        f = build_poisson_sharded(grid, lvl, mode, 0.8)
        edges = field_edges(f.layout, p)
        args = {"apply": (), "residual": (b,), "smooth": (b, lvl.inv_diag)}[mode]
        time_halo(f"poisson2d_halo {mode} 4096x4096 on (4, 2)", lambda: f(p, *args),
                  lambda: f.launch(p, edges, *args),
                  lambda: cuda_stencil.poisson2d(mode, p, lvl.coeffs, *args, omega=0.8),
                  lambda: cuda_stencil.poisson2d_halo_plain(mode, p, lvl.coeffs, f.layout,
                                                            edges, *args, omega=0.8),
                  nbytes(p, p, *args, *coeff_tensors(lvl.coeffs)) + edge_bytes(edges),
                  mesh.N[0] * mesh.N[1] * FLOPS_PER_CELL["poisson2d"][mode], reps)
    del p, b, lvl
    W = torch.randn((26, *mesh.N), generator=torch.Generator(device="cuda").manual_seed(24),
                    device="cuda")
    W[18:] = 0.0
    check_momentum2d_halo(entries, "4096^2 random planes", grid, mesh, W, rng)
    sm = build_momentum2d_sharded(grid, mesh, torch.float32)
    u, v = (torch.as_tensor(rng.standard_normal(mesh.N), dtype=torch.float32, device="cuda")
            for _ in range(2))
    ue, ve = field_edges(sm.layout, u), field_edges(sm.layout, v)
    time_halo("momentum2d_halo 4096x4096 on (4, 2) (random planes)", lambda: sm(W, u, v),
              lambda: sm.launch(W, u, v, ue, ve),
              lambda: cuda_stencil.momentum2d(W, u, v, mesh.periodic),
              lambda: cuda_stencil.momentum2d_halo_plain(W, u, v, sm.layout, ue, ve),
              nbytes(W, u, v, u, v) + edge_bytes(ue) + edge_bytes(ve),
              mesh.N[0] * mesh.N[1] * FLOPS_PER_CELL["momentum2d"], reps, plain_eager=True)


def phase_sharded(smi, entries, profile=False):
    """The domain-decomposed step (parallel/, NS.shard, -parallel_grid):
    the halo instances against their plain versions and the unsharded
    kernels on every periodic/wall combination of the reference's tests;
    the 256^2 Re 100 cavity on (4, 2), 21 steps, and BASELINE #5 (the
    512x256x256 channel, f32 production(3, 8, 6)) on (2, 2, 2), 11 steps,
    each against the unsharded unchained run of the same steps
    (SHARDED_RTOL), the 512 run also under its retention gate, with the
    halo instances checked at their shapes first and timed after; two
    planted edge-plane faults; the app with -parallel_grid in 2-D and 3-D.
    ``profile``: torch.profiler breakdowns of the sharded and unsharded
    runs. Returns the launches of the two sharded runs."""
    t0 = time.perf_counter()
    check_halo_combos(entries)

    def cavity():
        ns = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda")
        ns.impl.cfg = CNLinearConfig.production()
        return ns

    ref = unsharded_run(cavity, 21, "cavity 256^2 Re 100 f32 production", smi, profile)
    ns, launches2d, _ = sharded_run(cavity, (4, 2), 21,
                                    "cavity 256^2 Re 100 f32 production", smi, entries, ref,
                                    profile)
    time_halo_solver(entries, ns, {"calls": 50, "replays": 20})
    del ns, ref
    time_halo_2d_large(entries, {"calls": 5, "replays": 4})

    def channel():
        ns = setup_channel_3d(N=(512, 256, 256), dt=5e-5, stretch_y=2.0, device="cuda")
        ns.impl.cfg = CNLinearConfig.production(3, 8, 6)
        return ns

    gc.collect()
    torch.cuda.empty_cache()
    label = "channel 512x256x256 stretch_y 2.0 dt 5e-5 f32 production(3, 8, 6)"
    ref = unsharded_run(channel, 11, label, smi, profile)
    gc.collect()
    torch.cuda.empty_cache()
    ns, launches3d, u0 = sharded_run(channel, (2, 2, 2), 11, label, smi, entries, ref,
                                     profile)
    del ref
    retention = float(ns.state["v"][0].abs().mean()) / u0
    print(f"[sharded] {label} on (2, 2, 2): retention {retention:.5f} over 11 steps "
          f"(gate >= {RETENTION_MIN})", flush=True)
    if not retention >= RETENTION_MIN:
        raise AssertionError(f"sharded channel512 mean flow decayed: retention {retention}")
    planted_halo_faults(ns)
    time_halo_solver(entries, ns, {"calls": 5, "replays": 4})
    del ns
    gc.collect()
    torch.cuda.empty_cache()

    for argv in (["-cart_grid_x", "64", "-cart_grid_y", "64", "-parallel_grid", "2x2"],
                 ["-cart_dim", "3", "-cart_grid_x", "32", "-cart_grid_y", "32",
                  "-cart_grid_z", "32", "-parallel_grid", "2x2x2"]):
        argv = ["-device", "cuda", *argv, "-ns_max_steps", "3", "-ns_monitor"]
        with contextlib.redirect_stdout(io.StringIO()):
            ns = app.build(argv)
        check_sharded_solver(entries, f"app {' '.join(argv[2:-3])}", ns)
        del ns
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = app.main(argv)
        out = buf.getvalue()
        print(out, end="")
        if rc != 0 or "done: CONVERGED_ITS" not in out or "parallel: 1 devices" not in out:
            raise AssertionError(f"sharded app run {argv} did not end CONVERGED_ITS (rc {rc})")
    print(f"[sharded] done in {time.perf_counter() - t0:.2f} s", flush=True)
    return launches2d, launches3d


# ----------------------------------------------------------------------
# the multi-process step: one block per torch.distributed rank
# ----------------------------------------------------------------------

# The cells phase_ranks runs: the model and its dtype, the rank grid, the
# steps, and how the ranks' state is held against the one-process run of
# the same steps:
# - "tight" (float64): at SHARDED_RTOL. The two runs differ in the order of
#   the sums added over the ranks only, ~1e-14 after 21 steps of the 256^2
#   cavity (my CPU run, scratch reorder check);
# - "spread" (float32): within SPREAD_FACTOR times the one-process run's
#   own distance from a run whose dots sum over 8 row blocks (the same
#   steps, another order of the same sums), read in the same call. The
#   fixed-budget production solve of the 256^2 cavity is far from
#   converged, and in float32 such a reordering alone moves it by 1.0e-3
#   (v) and 5.2e-3 (p) after 21 steps on the CPU (the 8 ranks moved it by
#   1.4e-4 and 5.4e-4), far above SHARDED_RTOL, which phase_sharded meets
#   only because its sums are the unsharded ones. The ranks' order is
#   another draw of that size (at 64^2 on the CPU: 6.8e-7 against a
#   spread of 6.6e-7 in p), hence the factor;
# - "first" (float32, BASELINE #5): the first step within SPREAD_FACTOR
#   times the one-process step's one-rounding spread (field_dists, as
#   phase_chain_ab measures the 128^3 channel's: v moved by one rounding,
#   and here also the dots summed over 8 row blocks, the larger of the
#   two), then the retention gate over the steps. On a 32x16x16 cut of
#   the channel on the CPU the ranks moved the first step by 1.28e-7 (v)
#   against a one-rounding spread of 8.7e-8.
#
# The steps are cut to what 8 ranks on one card get through in about a
# minute: every edge plane and sum is a device-host round trip, and 8
# processes time-slice the card, so the 256^2 cavity steps at 0.145 steps/s
# on (4, 2) and the 64^3 channel at 0.097 (H100 80GB HBM3, 700 W, my chip
# run, PR 14); at 21 and 11 steps the phase took 515 s.
# Per-rank I/O (``io``): "restart" saves a "sharded" checkpoint after
# ``io_at`` steps, goes on to ``steps``, and a fresh rank-held solver loads
# the checkpoint shard-locally and runs to ``steps`` again, to equal the
# uninterrupted run at max abs 0; "reload" saves after the last step and
# loads back into the solver, timing both and reading the card's peak
# memory during the load.
RANK_CASES = {
    "cavity32": dict(label="cavity 256^2 Re 100 f32 production", grid=(4, 2), steps=6,
                     check="spread"),
    "cavity64": dict(label="cavity 256^2 Re 100 f64 production", grid=(4, 2), steps=6,
                     check="tight", io="restart", io_at=3),
    "channel64": dict(label="channel 64^3 dt 2e-3 f64 production", grid=(2, 2, 2),
                      steps=4, check="tight"),
    "channel512": dict(label="channel 512x256x256 stretch_y 2.0 dt 5e-5 f32 "
                       "production(3, 8, 6)", grid=(2, 1, 1), steps=3, check="first",
                       io="reload"),
}
RANK_TIMEOUT_S = 600
SPREAD_FACTOR = 4.0
# the most a rank-held load may add to the card's memory, in units of the
# rank's block state: the new block state (1.0) and a margin; one field of
# the whole grid of BASELINE #5 on (2, 1, 1) is 0.25 of it (2 blocks of one
# field against the block's 8 fields)
RELOAD_ADDED_MAX = 1.1


def rank_model(case, grid=None):
    """The solver of ``case``: the one-process one, or with ``grid`` (a
    rank-held grid) built on this rank's block from the start."""
    f64 = torch.float64
    if case.startswith("cavity"):
        ns = setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda",
                             dtype=f64 if case == "cavity64" else None, grid=grid)
        ns.impl.cfg = CNLinearConfig.production()
    elif case == "channel64":
        ns = setup_channel_3d(N=(64, 64, 64), dt=2e-3, device="cuda", dtype=f64, grid=grid)
        ns.impl.cfg = CNLinearConfig.production()
    else:
        ns = setup_channel_3d(N=BASELINE5, dt=5e-5, stretch_y=2.0, device="cuda", grid=grid)
        ns.impl.cfg = CNLinearConfig.production(3, 8, 6)
    return ns


def blocked_dot(nblocks):
    """``tree_dot`` with each leaf's sum taken over ``nblocks`` row blocks
    and the partial sums added in order: the same sums in another order."""
    from fluca_tpu_torch.solvers.krylov import tree_dot, tree_leaves

    def dot(a, b):
        tot = None
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            parts = [tree_dot(p, q) for p, q in zip(x.chunk(nblocks, 0), y.chunk(nblocks, 0))]
            d = parts[0]
            for q in parts[1:]:
                d = d + q
            tot = d if tot is None else tot + d
        return tot

    return dot


def mean_abs_u(ns) -> float:
    """mean |u| over the grid (summed over the ranks where rank-held)."""
    u = ns.state["v"][0]
    s = torch.stack([u.abs().double().sum(), torch.tensor(float(u.numel()), device=u.device,
                                                           dtype=torch.float64)])
    if ns.impl.rank_held:
        s = ns.device_grid.allsum(s)
    return float(s[0] / s[1])


def state_leaves(state):
    """(name, tensor, face axis or None) for every state field."""
    out = [(f"v{c}", x, None) for c, x in enumerate(state["v"])]
    out += [(f"U{d}", x, d) for d, x in enumerate(state["U"])]
    return out + [("p", state["p"], None), ("phalf", state["phalf"], None)]


def rank_state_errors(ns, ref, vol=None):
    """||a - b|| / ||b|| over v, over U and over p (with ``vol``: p less its
    volume-weighted mean, as field_dists takes it), and the max abs
    differences, of this rank's state against its block of the whole
    state ``ref`` (CPU tensors), summed over the ranks."""
    grid = ns.device_grid
    blk = grid.block(ns.mesh.N, ns.mesh.periodic)
    whole = {name: (x, face) for name, x, face in state_leaves(ref)}
    groups = {"v": [], "U": [], "p": []}
    for name, x, face in state_leaves(ns.state):
        if name != "phalf":
            b = blk.cut(whole[name][0], face).to(x.device)
            groups[name[0]].append((x.double(), b.double()))
    if vol is not None:
        a, b = groups["p"][0]
        v = blk.cut(vol).to(a.device, torch.float64)
        m = grid.allsum(torch.stack([torch.sum(v * a), torch.sum(v * b), torch.sum(v)]))
        groups["p"] = [(a - m[0] / m[2], b - m[1] / m[2])]
    sums, maxes = [], []
    for k in ("v", "U", "p"):
        sums.append(sum(torch.sum((a - b) ** 2) for a, b in groups[k]))
        sums.append(sum(torch.sum(b ** 2) for _, b in groups[k]))
        maxes.append(max((a - b).abs().max() for a, b in groups[k]))
    tot = grid.allsum(torch.stack(sums))
    mx = torch.stack(grid.transport.all_gather(torch.stack(maxes))).max(0).values
    return ({k: float((tot[2 * i] / tot[2 * i + 1]) ** 0.5) for i, k in enumerate("vUp")},
            {k: float(mx[i]) for i, k in enumerate("vUp")})


def planted_rank_fault(ns):
    """Zero one received edge plane of the finest level's Poisson apply
    on every rank (along axis 0: the plane from the high neighbour, or on
    the last rank the one from the low neighbour) and run it: the result
    must part from the plain version on the true planes and from the
    one-card sharded call's box. Returns this rank's readings."""
    from fluca_tpu_torch.parallel.mesh import DeviceGrid

    impl, grid = ns.impl, ns.device_grid
    lvl = impl.mg.levels[0]
    f = lvl.sharded["apply"]
    gen = torch.Generator(device="cpu").manual_seed(31 + grid.rank)
    p = torch.randn(lvl.shape, generator=gen).to("cuda", impl.dtype)
    edges = f.edges(p)
    side = 1 if grid.coords[0] < grid.shape[0] - 1 else 0
    bad = [None if e is None else [t.clone() for t in e] for e in edges]
    bad[0][side].zero_()
    got = f.launch(p, bad)
    plain = f.kernel._plain("apply", p, lvl.coeffs, f.layout, edges)
    pg = grid.gather(p, lvl.mesh.N, lvl.mesh.periodic)
    glvl = mg_mod._build_level(lvl.mesh, impl.ops.axbcs, impl.dt / impl.rho, impl.dtype,
                               "cuda")
    one = build_poisson_sharded(DeviceGrid(grid.shape, (torch.device("cuda"),) * grid.size),
                                glvl, "apply", impl.mg.omega)
    box = lvl.block.cut(one(pg))
    torch.cuda.synchronize()
    return {"rel_vs_plain": rel_err(got, plain), "max_abs_vs_one_card": max_abs(got, box)}


def all_launches():
    """Each kernel's launches since the last reset, all instances."""
    return {k.name: k.launches for k in cuda_stencil.KERNELS}


def rank_dir(args, *names):
    """A path in the directory of the case's files (that of ``--ref``)."""
    return os.path.join(os.path.dirname(args.ref), *names)


def state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for _, x, _ in state_leaves(state))


def host_state(state) -> dict:
    """CPU copies of a state's fields."""
    return {k: tuple(x.cpu() for x in v) if isinstance(v, tuple) else v.cpu()
            for k, v in state.items()}


def rank_save(ns, args, gathered=False) -> dict:
    """The rank-held "sharded" checkpoint of ``ns`` (with ``gathered``, rank
    0 also saves the gathered state, for the parent's one-process load),
    timed: the seconds from the first byte to the barrier that ends the
    save, this rank's bytes and their rate."""
    if gathered:
        state = ns.gather_state()
        if state is not None:
            torch.save(host_state(state), rank_dir(args, f"{args.case}.gathered.pt"))
        del state
    ck = rank_dir(args, f"{args.case}.ck")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(ck, ns)
    s = time.perf_counter() - t0
    nbytes = state_bytes(ns.state)
    return {"s": s, "bytes": nbytes, "gb_per_s": nbytes / s / 1e9, "step": ns.step_index}


def rank_load(ns, args) -> dict:
    """Load the case's checkpoint into ``ns``, shard-locally, timed: the
    bytes read must be this rank's block's bytes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reader = load_checkpoint(rank_dir(args, f"{args.case}.ck"), ns)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    nbytes = state_bytes(ns.state)
    if reader is None or reader.nbytes_read != nbytes:
        raise AssertionError(f"rank {args.rank}: the shard-local load read "
                             f"{None if reader is None else reader.nbytes_read} bytes, its "
                             f"block holds {nbytes}")
    return {"s": s, "bytes": nbytes, "nbytes_read": reader.nbytes_read,
            "gb_per_s": nbytes / s / 1e9}


def states_equal_over_ranks(grid, a, b) -> float:
    """The max abs difference of two block states (b may be on the host),
    the most over the ranks."""
    d = max(float((x.double().cpu() - y.double().cpu()).abs().max())
            for (_, x, _), (_, y, _) in zip(state_leaves(a), state_leaves(b)))
    return float(grid.transport.allmax(torch.tensor([d], dtype=torch.float64,
                                                    device="cuda"))[0])


def rank_restart(ns, args, spec) -> dict:
    """A fresh rank-held solver loads the checkpoint of io_at steps and runs
    to ``steps``: every rank's state must equal the uninterrupted run's at
    max abs 0. A checkpoint of another grid must be refused (ValueError)."""
    grid = ns.device_grid
    re = rank_model(args.case, grid)
    try:
        load_checkpoint(rank_dir(args, "other.ck"), re)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"rank {args.rank}: a checkpoint of another grid was loaded")
    fig = rank_load(re, args)
    fig["loaded_step"] = re.step_index
    cuda_stencil.reset_launch_counts()
    re.advance(spec["steps"] - re.step_index)
    torch.cuda.synchronize()
    fig["launches_per_step"] = {k: v / (spec["steps"] - fig["loaded_step"])
                                for k, v in all_launches().items() if v}
    fig["max_abs_vs_uninterrupted"] = states_equal_over_ranks(grid, re.state, ns.state)
    fig["refused_other_grid"] = refused
    if importlib.util.find_spec("h5py") is not None:
        # the hyperslab CGNS file of the checkpoint's state, read back on the
        # ranks (and by the parent in one process)
        from fluca_tpu_torch.io.cgns import CGNSWriter, load_solution_cgns

        re = rank_model(args.case, grid)
        load_checkpoint(rank_dir(args, f"{args.case}.ck"), re)
        with CGNSWriter(rank_dir(args, f"{args.case}.cgns"), re.mesh) as w:
            w.write_solution(re)
        back = rank_model(args.case, grid)
        load_solution_cgns(rank_dir(args, f"{args.case}.cgns"), back)
        fig["cgns_max_abs"] = states_equal_over_ranks(grid, back.state, re.state)
    return fig


def rank_reload(ns, args) -> dict:
    """Load the checkpoint just saved back into ``ns``: equal to the saved
    state at max abs 0; the card's peak memory during the load."""
    saved = host_state(ns.state)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fig = rank_load(ns, args)
    fig["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    fig["added_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
    fig["max_abs_vs_saved"] = states_equal_over_ranks(ns.device_grid, ns.state, saved)
    return fig


def rank_main(args) -> int:
    """One rank of phase_ranks: join the gloo group on cuda:0 (ranks that
    share one card), load the library the parent built, run the case
    sharded over the rank grid with the counts at 0, hold the state
    against the parent's one-process run, check every kernel call, and
    write this rank's figures to its output file."""
    from fluca_tpu_torch.parallel import distributed
    from fluca_tpu_torch.parallel.ranks import rank_kernel_checks

    lib = cuda_stencil.build_dir() / cuda_stencil.source_hash() / cuda_stencil.LIB_NAME
    if not lib.exists():
        raise RuntimeError(f"rank {args.rank}: no kernel library at {lib}: the parent "
                           f"builds it before it starts the ranks")
    dev = distributed.initialize_distributed(
        backend="gloo", init_method=f"file://{args.init}", world_size=args.world,
        rank=args.rank, device="cuda:0", timeout_s=RANK_TIMEOUT_S)
    transport = distributed.default_transport()
    print(f"[ranks] rank {args.rank}/{args.world}: backend {transport.backend}, device "
          f"{dev}, planes staged through pinned host buffers: {transport.staged}",
          flush=True)
    spec = RANK_CASES[args.case]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the solver and its state built on this rank's block from the start
    ns = rank_model(args.case, make_device_grid(len(spec["grid"]), shape=spec["grid"]))
    build_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    u0 = mean_abs_u(ns)
    if not isinstance(ns.impl._stages, UnfusedChain) or ns.impl._pre_resources() is not None \
            or not ns.impl.rank_held:
        raise AssertionError(f"{args.case}: the rank-held solver must run UnfusedChain, "
                             f"bf16 off")
    ref = torch.load(args.ref, mmap=True, weights_only=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    transport.stats.reset()
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    ns.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = {"rank": args.rank, "coords": list(ns.device_grid.coords),
           "backend": transport.backend, "device": str(dev)}
    if spec["check"] == "first":
        launches = all_launches()
        xs = transport.stats.as_dict()
        out["first_errors"], out["first_max_abs"] = rank_state_errors(
            ns, ref, torch.as_tensor(ns.mesh.cell_volumes()))
        transport.stats.reset()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ns.advance(spec["steps"] - 1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in all_launches().items():
            launches[k] += v
        for k, v in transport.stats.as_dict().items():
            xs[k] += v
        adv = (t3 - t2, spec["steps"] - 1)
    else:
        n1 = spec["steps"] - 1 if spec.get("io") != "restart" else spec["io_at"] - 1
        t2 = time.perf_counter()
        ns.advance(n1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = all_launches()
        xs = transport.stats.as_dict()
        adv_s = t3 - t2
        if n1 < spec["steps"] - 1:
            # the checkpoint at io_at steps, then on to the last step
            out["save"] = rank_save(ns, args, gathered=True)
            transport.stats.reset()
            cuda_stencil.reset_launch_counts()
            t2 = time.perf_counter()
            ns.advance(spec["steps"] - 1 - n1)
            torch.cuda.synchronize()
            adv_s += time.perf_counter() - t2
            for k, v in all_launches().items():
                launches[k] += v
            for k, v in transport.stats.as_dict().items():
                xs[k] += v
        adv = (adv_s, spec["steps"] - 1)
        out["errors"], out["max_abs"] = rank_state_errors(ns, ref)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["build_peak_gib"] = build_peak
    if not bool(ns.last_diag["converged"]):
        raise AssertionError(f"{args.case}: step {ns.step_index} did not converge")
    assert_finite(ns, f"{args.case} on rank {args.rank}")
    if spec["check"] == "first":
        out["retention"] = mean_abs_u(ns) / u0
    out.update(first_s=t1 - t0, advance_s=adv[0], steps_per_s=adv[1] / adv[0],
               launches=launches, exchange=xs, steps=spec["steps"],
               levels=[list(n) for n in ns.impl.mg.sharded_levels])
    if spec.get("io") == "restart":
        out["restart"] = rank_restart(ns, args, spec)
    elif spec.get("io") == "reload":
        out["save"] = rank_save(ns, args)
        out["reload"] = rank_reload(ns, args)
        # the load may add the new block state (the old one is freed as
        # each field is replaced), never a field of the whole grid
        block_gib = state_bytes(ns.state) / 2**30
        if out["reload"]["peak_gib"] > out["peak_gib"] \
                or out["reload"]["added_gib"] > RELOAD_ADDED_MAX * block_gib:
            raise AssertionError(f"rank {args.rank}: the load's peak "
                                 f"{out['reload']['peak_gib']:.3f} GiB (stepping peak "
                                 f"{out['peak_gib']:.3f}), "
                                 f"{out['reload']['added_gib']:.3f} GiB above what the rank "
                                 f"held (bound {RELOAD_ADDED_MAX:g} x its block state "
                                 f"{block_gib:.3f} GiB)")
    checks = rank_kernel_checks(ns, seed=41)
    out["checks"] = len(checks)
    out["max_abs_vs_one_card"] = max(c["max_abs_vs_one_card"] for c in checks)
    out["max_rel_vs_plain"] = max(c["rel_vs_plain"] for c in checks)
    if args.case == "cavity32":
        out["fault"] = planted_rank_fault(ns)
    out["ledger"] = {k.name: {"launched": sorted(map(repr, k.launched)),
                              "checked": sorted(map(repr, k.checked))}
                     for k in cuda_stencil.KERNELS}
    with open(args.out, "w") as fh:
        json.dump(out, fh)
    distributed.finalize_distributed()
    print(f"[ranks] rank {args.rank}/{args.world}: OK {args.case}", flush=True)
    return 0


def one_process_reference(case, tmp, entries):
    """The one-process run of ``case``, unchained as the rank-held step
    runs: the saved state the ranks are held against (after all steps, or
    after the first for "first"), its steps/s and peak memory; for
    "first", also the first step's one-rounding spread (field_dists of a
    run whose initial v is moved by one float32 rounding); for "spread",
    the run's distance from the same run with its dots summed over 8 row
    blocks (``blocked_dot``)."""
    spec = RANK_CASES[case]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ns = rank_model(case)
    # what building the solver took, less what this process already held
    build_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    unchain(ns)
    check_solver_stencils(entries, f"{spec['label']}, one process", ns)
    torch.cuda.reset_peak_memory_stats()
    u0 = float(ns.state["v"][0].abs().mean())
    fig = {}
    if spec["check"] == "first":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ns.step()
        torch.cuda.synchronize()
        fig["first_s"] = time.perf_counter() - t0
        saved = host_state(ns.state)
        t0 = time.perf_counter()
        ns.advance(spec["steps"] - 1)
        torch.cuda.synchronize()
        adv = time.perf_counter() - t0
        fig["retention"] = float(ns.state["v"][0].abs().mean()) / u0
    else:
        fig["first_s"], adv, _ = timed_run(ns, spec["steps"] - 1)
        saved = host_state(ns.state)
    fig.update(steps_per_s=(spec["steps"] - 1) / adv, peak_gib=torch.cuda.max_memory_allocated()
               / 2**30, build_peak_gib=build_peak)
    assert_finite(ns, f"{case}, one process")
    path = os.path.join(tmp, f"{case}.pt")
    torch.save(saved, path)
    del ns
    if spec["check"] != "tight":
        # the same run one rounding away: v moved by one rounding (the first
        # step), or the dots summed in another order (all the steps)
        gc.collect()
        torch.cuda.empty_cache()
        ns = rank_model(case)
        unchain(ns)
        ref = {k: tuple(x.cuda() for x in v) if isinstance(v, tuple) else v.cuda()
               for k, v in saved.items()}
        if spec["check"] == "first":
            eps = torch.finfo(ns.impl.dtype).eps
            ns.state["v"] = tuple(x * (1.0 + eps) for x in ns.state["v"])
            ns.step()
            vol = torch.as_tensor(ns.mesh.cell_volumes(), device="cuda")
            fig["moved"] = field_dists(ns.state, ref, vol)
            del ns
            gc.collect()
            torch.cuda.empty_cache()
            ns = rank_model(case)
            unchain(ns)
            ns.impl._dot = blocked_dot(8)
            ns.step()
            fig["blocked"] = field_dists(ns.state, ref, vol)
            fig["spread"] = {k: max(fig["moved"][k], fig["blocked"][k]) for k in "vUp"}
        else:
            ns.impl._dot = blocked_dot(8)
            ns.step()
            ns.advance(spec["steps"] - 1)
            st = ns.state
            fig["spread"] = {"v": vec_rel_err(st["v"], ref["v"]),
                             "U": vec_rel_err(st["U"], ref["U"]),
                             "p": rel_err(st["p"], ref["p"])}
        del ns, ref
    gc.collect()
    torch.cuda.empty_cache()
    return path, fig


def run_rank_case(case, tmp, ref_path):
    """Start one process per rank of ``case`` (file:// init, a timeout);
    kill every rank and fail if any fails or hangs. Returns each rank's
    figures."""
    spec = RANK_CASES[case]
    world = int(np.prod(spec["grid"]))
    init = os.path.join(tmp, f"{case}.init")
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"{case}.rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world",
             str(world), "--init", init, "--case", case, "--ref", ref_path,
             "--out", os.path.join(tmp, f"{case}.rank{r}.json")],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(REPO)))
    failed = None
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed = f"rank {r} hung past {RANK_TIMEOUT_S} s"
                break
            if rc != 0:
                failed = f"rank {r} exited {rc}"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            text = log.read()
            log.close()
            if failed or r == 0:
                tails.append(f"--- rank {r} ---\n" + text[-4000:])
        if failed:
            print("\n".join(tails), flush=True)
    if failed:
        raise AssertionError(f"phase_ranks {case}: {failed}")
    print(tails[0], end="", flush=True)
    figs = []
    for r in range(world):
        with open(os.path.join(tmp, f"{case}.rank{r}.json")) as fh:
            figs.append(json.load(fh))
    return figs


def merge_rank_ledger(figs):
    """Every rank's launched and checked keys into this process's ledger,
    so that phase_ledger fails on a key no check covered."""
    import ast

    kernels = {k.name: k for k in cuda_stencil.KERNELS}
    for f in figs:
        for name, led in f["ledger"].items():
            kernels[name].launched |= {ast.literal_eval(k) for k in led["launched"]}
            kernels[name].checked |= {ast.literal_eval(k) for k in led["checked"]}


def rank_io_report(case, spec, tmp, figs, smi):
    """The per-rank I/O of ``case`` (``io`` of RANK_CASES): its save and
    load per rank; for "restart", the restart against the uninterrupted
    run (max abs 0, read on the ranks), one process's load of the ranks'
    checkpoint against rank 0's gathered state (max abs 0), and a planted
    fault (one manifest loses a record: IOError); for "reload", the
    reload against the saved state (max abs 0) and the card's peak memory
    during the load, and the checkpoint removed."""
    label, ck = spec["label"], os.path.join(tmp, f"{case}.ck")
    saves = [f["save"] for f in figs]
    loads = [f["restart"] if spec["io"] == "restart" else f["reload"] for f in figs]
    print(f"[rank-io] {label} on {spec['grid']} ({smi}): 'sharded' checkpoint at step "
          f"{saves[0]['step']}, per rank: save "
          + ", ".join(f"{x['s']:.4f} s ({x['bytes'] / 2**20:.1f} MiB, {x['gb_per_s']:.3f} "
                      f"GB/s)" for x in saves)
          + "; shard-local load "
          + ", ".join(f"{x['s']:.4f} s ({x['nbytes_read'] / 2**20:.1f} MiB read = its "
                      f"block, {x['gb_per_s']:.3f} GB/s)" for x in loads), flush=True)
    if spec["io"] == "restart":
        d = max(x["max_abs_vs_uninterrupted"] for x in loads)
        print(f"[rank-io] {label}: restart from step {loads[0]['loaded_step']} to "
              f"{spec['steps']} against the uninterrupted run, max abs {d:.3e} (every rank; "
              f"launches per rank per step {loads[0]['launches_per_step']}); "
              f"a checkpoint of another grid refused on every rank: "
              f"{loads[0]['refused_other_grid']!r}", flush=True)
        if d != 0.0:
            raise AssertionError(f"{label}: the restart differs from the uninterrupted "
                                 f"run by {d:.3e}")
        one = rank_model(case)
        if load_checkpoint(ck, one) is not None:
            raise AssertionError("one process read the 'sharded' checkpoint by blocks")
        gathered = torch.load(os.path.join(tmp, f"{case}.gathered.pt"), weights_only=True)
        d1 = states_max_abs(host_state(one.state), gathered)
        print(f"[rank-io] {label}: one process loads the ranks' checkpoint: max abs "
              f"{d1:.3e} from rank 0's gather_state()", flush=True)
        if d1 != 0.0:
            raise AssertionError(f"{label}: one process's load differs by {d1:.3e}")
        shutil.copytree(ck, ck + ".bad")
        mpath = os.path.join(ck + ".bad", "manifest.p3.json")
        with open(mpath) as fh:
            records = json.load(fh)
        del records["v0"]
        with open(mpath, "w") as fh:
            json.dump(records, fh)
        try:
            load_checkpoint(ck + ".bad", rank_model(case))
        except IOError as e:
            print(f"[rank-io] planted fault (manifest.p3 lost its record of v0): {e}",
                  flush=True)
        else:
            raise AssertionError("a checkpoint whose manifest lost a record was loaded")
        if "cgns_max_abs" in figs[0]:
            from fluca_tpu_torch.io.cgns import load_solution_cgns

            dc = max(f["restart"]["cgns_max_abs"] for f in figs)
            one = rank_model(case)
            load_solution_cgns(os.path.join(tmp, f"{case}.cgns"), one)
            d2 = states_max_abs(host_state(one.state), gathered)
            print(f"[rank-io] {label}: the hyperslab CGNS file read back on the ranks, max "
                  f"abs {dc:.3e}; in one process, {d2:.3e} from gather_state()", flush=True)
            if dc != 0.0 or d2 != 0.0:
                raise AssertionError(f"{label}: CGNS round trip {dc:.3e}, {d2:.3e}")
        else:
            print("[rank-io] CGNS: the hyperslab writer and reader are held on the CPU "
                  "(tests/test_torch_rank_io.py), not here: this host has no h5py",
                  flush=True)
        del one
    else:
        d = max(x["max_abs_vs_saved"] for x in loads)
        print(f"[rank-io] {label}: reload max abs {d:.3e} from the saved state; the card's "
              f"peak memory per rank during the load "
              + ", ".join(f"{x['peak_gib']:.3f} GiB (+{x['added_gib']:.3f})" for x in loads)
              + " against the stepping peak "
              + ", ".join(f"{f['peak_gib']:.3f}" for f in figs), flush=True)
        if d != 0.0:
            raise AssertionError(f"{label}: the reload differs by {d:.3e}")
        shutil.rmtree(ck)


def phase_ranks(smi, entries):
    """The multi-process step: one block per torch.distributed rank, the
    ranks sharing the one card under gloo with their edge planes staged
    through pinned host buffers. Each case of RANK_CASES against the
    one-process run of the same steps, by its ``check``: "tight" (f64
    cavity and 64^3 channel) at SHARDED_RTOL, "spread" (f32 cavity) within
    SPREAD_FACTOR x the one-process run's distance from itself with its
    dots summed over 8 row blocks, "first" (BASELINE #5 on (2, 1, 1)) its
    first step within SPREAD_FACTOR x the one-rounding spread, then its
    retention gate. Every rank holds its kernel calls against the one-card sharded
    calls (max abs 0) and their plain versions; one planted edge-plane
    fault per rank in the cavity must be caught. Returns each case's
    launches summed over its ranks."""
    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(dir=cuda_stencil.build_dir()) as tmp:
        for case, spec in RANK_CASES.items():
            ref_path, one = one_process_reference(case, tmp, entries)
            if spec.get("io") == "restart":
                # a checkpoint of another grid, for the ranks to refuse
                save_checkpoint(os.path.join(tmp, "other.ck"), setup_cavity_2d(
                    N=128, Re=100.0, dt=0.01, device="cuda", dtype=torch.float64))
            figs = run_rank_case(case, tmp, ref_path)
            merge_rank_ledger(figs)
            label, world = spec["label"], len(figs)
            tot = {}
            for f in figs:
                for k, v in f["launches"].items():
                    tot[k] = tot.get(k, 0) + v
            launches[case] = tot
            names = (("poisson2d_halo", "momentum2d_halo") if len(spec["grid"]) == 2
                     else ("poisson3d_halo", "momentum3d_halo"))
            require_launches(tot, names, f"{label} on the ranks")
            sps = min(f["steps_per_s"] for f in figs)
            steps = spec["steps"]
            xs = [f["exchange"] for f in figs]
            print(f"[ranks] {label} on {spec['grid']} ({world} ranks, gloo, cuda:0; {smi}): "
                  f"advance({steps - 1}) {sps:.4f} steps/s (slowest rank) against "
                  f"{one['steps_per_s']:.4f} one process; first step "
                  f"{max(f['first_s'] for f in figs) * 1e3:.1f} ms against "
                  f"{one['first_s'] * 1e3:.1f}; levels held {figs[0]['levels']}; launches "
                  f"per step, all ranks {per_step(tot, steps)}", flush=True)
            print(f"[ranks] {label}: per rank per step, exchanges "
                  f"{min(x['exchanges'] for x in xs) / steps:.1f}, "
                  f"{max(x['exchange_bytes'] for x in xs) / steps / 2**20:.4f} MiB sent "
                  f"(most); sums {xs[0]['sums'] / steps:.1f} and gathers "
                  f"{xs[0]['gathers'] / steps:.1f}; "
                  f"peak memory per rank {max(f['peak_gib'] for f in figs):.3f} GiB stepping, "
                  f"{max(f['build_peak_gib'] for f in figs):.3f} GiB building, against "
                  f"{one['peak_gib']:.3f} and {one['build_peak_gib']:.3f} GiB one process",
                  flush=True)
            d = max(f["max_abs_vs_one_card"] for f in figs)
            print(f"[ranks] {label}: {sum(f['checks'] for f in figs)} rank kernel calls, max "
                  f"abs {d:.3e} from the one-card sharded calls' boxes, max rel "
                  f"{max(f['max_rel_vs_plain'] for f in figs):.3e} from the plain versions",
                  flush=True)
            if d != 0.0:
                raise AssertionError(f"{label}: a rank's kernel call differs from the "
                                     f"one-card sharded call by {d:.3e}")
            for name in names:
                e = entries[name]
                e.setdefault("launches_ranks", {})[f"{label} on {spec['grid']}"] = tot[name]
                e["max_abs_vs_one_card"] = max(e.get("max_abs_vs_one_card", 0.0), d)
            f0 = figs[0]
            if spec["check"] != "first":
                bound = ({k: SHARDED_RTOL for k in "vUp"} if spec["check"] == "tight"
                         else {k: SPREAD_FACTOR * x for k, x in one["spread"].items()})
                print(f"[ranks] {label}, ranks vs one process after {steps} steps: "
                      + ", ".join(f"{k} rel {f0['errors'][k]:.4e} (bound {bound[k]:.4e}) "
                                  f"max abs {f0['max_abs'][k]:.4e}" for k in f0["errors"])
                      + ("; the bound: SHARDED_RTOL" if spec["check"] == "tight" else
                         f"; the bound: {SPREAD_FACTOR:g} x the one-process run against "
                         f"itself with its dots summed over 8 row blocks"), flush=True)
                for k, e in f0["errors"].items():
                    if not e <= bound[k] < 1.0:
                        raise AssertionError(f"{label}: ranks vs one process {k} rel {e:.4e}, "
                                             f"bound {bound[k]:.4e}")
            else:
                bound = {k: SPREAD_FACTOR * x for k, x in one["spread"].items()}
                print(f"[ranks] {label}, ranks vs one process, first step: "
                      + ", ".join(f"{k} {f0['first_errors'][k]:.4e} (one rounding of v "
                                  f"{one['moved'][k]:.4e}, dots over 8 row blocks "
                                  f"{one['blocked'][k]:.4e}; bound {bound[k]:.4e})"
                                  for k in bound)
                      + f"; retention over {steps} steps {f0['retention']:.5f} (one process "
                      f"{one['retention']:.5f}; gate >= {RETENTION_MIN})", flush=True)
                for k in bound:
                    if not f0["first_errors"][k] <= bound[k] < 1.0:
                        raise AssertionError(f"{label}: first step {k} "
                                             f"{f0['first_errors'][k]:.4e} outside "
                                             f"{SPREAD_FACTOR:g} x the one-rounding spread "
                                             f"{one['spread'][k]:.4e}")
                if not f0["retention"] >= RETENTION_MIN:
                    raise AssertionError(f"{label}: retention {f0['retention']}")
            if spec.get("io"):
                rank_io_report(case, spec, tmp, figs, smi)
            if case == "cavity32":
                faults = [f["fault"] for f in figs]
                print(f"[ranks] planted fault (one received edge plane of the finest "
                      f"Poisson apply zeroed on each rank): rel from the plain version "
                      f"{min(x['rel_vs_plain'] for x in faults):.4e} (least), max abs from "
                      f"the one-card call {min(x['max_abs_vs_one_card'] for x in faults):.4e} "
                      f"(least)", flush=True)
                for x in faults:
                    if not (x["rel_vs_plain"] > KERNEL_RTOL[torch.float32]
                            and x["max_abs_vs_one_card"] > 0.0):
                        raise AssertionError(f"the planted rank fault passed: {x}")
    print(f"[ranks] done in {time.perf_counter() - t0:.2f} s", flush=True)
    return launches


# ----------------------------------------------------------------------
# the entry points under a launcher
# ----------------------------------------------------------------------

LAUNCH_TIMEOUT_S = 300
APP_RANKS_ARGV = ["-device", "cuda", "-cart_grid_x", "64", "-cart_grid_y", "64",
                  "-ns_max_steps", "3", "-ns_monitor"]
# bench_scaling's base and timed steps here (small: the records are
# printed, not gated); ici_bytes's rank grid here: (2, 1), the reference's
# ICI_BYTES_2dev.json (the script's (4, 2) is run by hand)
BENCH_BASE, BENCH_STEPS = 64, 1
ICI_GRID = "2x1"


def launched_main(args) -> int:
    """One rank of phase_launchers' launch (started by
    ``torch.distributed.run``): run each entry point of the ``--launched``
    file as ``python -m`` runs it (``runpy``, as ``__main__``, with its
    argv), keeping every NS they build; then hold every kernel call of
    those solvers against its plain version (a rank-held solver also
    against the one-card sharded calls, ``rank_kernel_checks``; a
    one-process one through check_solver_stencils) and write this rank's
    launch ledger to ``--out``. The entry points' own
    ``finalize_distributed`` is put off until after the checks, which
    need the process group."""
    import runpy

    from fluca_tpu_torch.ns.ns import NS
    from fluca_tpu_torch.parallel import distributed
    from fluca_tpu_torch.parallel.ranks import rank_kernel_checks

    rank = int(os.environ["RANK"])
    lib = cuda_stencil.build_dir() / cuda_stencil.source_hash() / cuda_stencil.LIB_NAME
    if not lib.exists():
        raise RuntimeError(f"rank {rank}: no kernel library at {lib}: the parent builds it "
                           f"before it starts the launch")
    with open(args.launched) as fh:
        spec = json.load(fh)
    built, init, finalize, argv = [], NS.__init__, distributed.finalize_distributed, sys.argv

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)

    NS.__init__ = keep
    distributed.finalize_distributed = lambda: None
    try:
        for module, margv in spec:
            sys.argv = [module, *margv]
            try:
                runpy.run_module(module, run_name="__main__", alter_sys=True)
            except SystemExit as e:
                if e.code not in (None, 0):
                    raise AssertionError(f"rank {rank}: {module} exited {e.code}") from e
    finally:
        NS.__init__, distributed.finalize_distributed, sys.argv = init, finalize, argv
    checks, one = [], 0
    entries = kernel_entries()
    for i, ns in enumerate(built):
        if ns.impl.rank_held:
            checks += rank_kernel_checks(ns, seed=43 + i)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                check_solver_stencils(entries, f"one process {ns.mesh.N}", ns)
            one += 1
    out = {"rank": rank, "solvers": len(built), "one_process": one, "checks": len(checks),
           "max_abs_vs_one_card": max(c["max_abs_vs_one_card"] for c in checks),
           "max_rel_vs_plain": max(c["rel_vs_plain"] for c in checks),
           "ledger": {k.name: {"launched": sorted(map(repr, k.launched)),
                               "checked": sorted(map(repr, k.checked))}
                      for k in cuda_stencil.KERNELS}}
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    finalize()
    return 0


def launch(nproc, argv, what):
    """Run ``argv`` on ``nproc`` ranks under ``python -m
    torch.distributed.run --standalone`` (a new session, killed whole where
    it fails or outlasts LAUNCH_TIMEOUT_S); returns its output and the
    JSON objects it printed, one per line."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *argv]
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        out = b""
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    text = out.decode(errors="replace")
    if proc.returncode != 0:
        print(text[-6000:], flush=True)
        raise AssertionError(f"{what}: exit {proc.returncode} ({' '.join(cmd[2:])})")
    return text, [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def phase_launchers(smi, entries):
    """The entry points under ``python -m torch.distributed.run`` (2 ranks
    sharing the card under gloo), in one launch whose ranks run this
    script (``launched_main``): the app on the 64^2 cavity over 2x1 ranks
    with -checkpoint, then bench_scaling and ici_bytes over 2x1 ranks;
    every kernel call of the solvers they built is checked in the ranks
    and their ledgers merged into this process's, so that phase_ledger
    fails on a key no check covered. The app prints one done: line; its
    checkpoint, loaded by one process, is held against the one-process
    app run within SPREAD_FACTOR x that run's distance from itself with
    its dots over 8 row blocks (float32, FGMRES rtol 1e-5, as phase_ranks
    holds its float32 cell). Then bench_scaling in one process
    (--shards 4); the records are printed (no gate)."""
    from fluca_tpu_torch.examples import bench_scaling

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=cuda_stencil.build_dir()) as tmp:
        ck, spec = os.path.join(tmp, "app.ck"), os.path.join(tmp, "entries.json")
        # the entry points the ranks run, in this order: (module, argv)
        with open(spec, "w") as fh:
            json.dump([("fluca_tpu_torch.app", APP_RANKS_ARGV + [
                           "-parallel_grid", "2x1", "-parallel_backend", "gloo",
                           "-checkpoint", ck]),
                       ("fluca_tpu_torch.examples.bench_scaling",
                        ["--backend", "gloo", "--base", str(BENCH_BASE), "--steps",
                         str(BENCH_STEPS)]),
                       ("fluca_tpu_torch.examples.ici_bytes",
                        ["--backend", "gloo", "--grid", ICI_GRID])], fh)
        text, recs = launch(2, [str(Path(__file__).resolve()), "--launched", spec,
                                "--out", tmp], "the entry points on 2 ranks")
        ta = time.perf_counter() - t0
        figs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                figs.append(json.load(fh))
        merge_rank_ledger(figs)
        d = max(f["max_abs_vs_one_card"] for f in figs)
        print(f"[launch] app, bench_scaling and ici_bytes on 2 ranks (gloo, cuda:0; {smi}) "
              f"in {ta:.2f} s: {sum(f['solvers'] for f in figs)} solvers over the ranks "
              f"({sum(f['one_process'] for f in figs)} of one process), "
              f"{sum(f['checks'] for f in figs)} rank kernel calls, max abs {d:.3e} from "
              f"the one-card sharded calls' boxes, max rel "
              f"{max(f['max_rel_vs_plain'] for f in figs):.3e} from the plain versions",
              flush=True)
        if d != 0.0:
            raise AssertionError(f"the launched entry points: a rank's kernel call differs "
                                 f"from the one-card sharded call by {d:.3e}")
        for name in ("poisson2d_halo", "momentum2d_halo"):
            e = entries[name]
            e["max_abs_vs_one_card"] = max(e.get("max_abs_vs_one_card", 0.0), d)
        done = [ln for ln in text.splitlines() if ln.startswith("done:")]
        print("\n".join(ln for ln in text.splitlines()
                        if ln.startswith(("parallel:", "step ", "done:"))), flush=True)
        if len(done) != 1 or "CONVERGED_ITS at step 3" not in done[0]:
            raise AssertionError(f"the app on ranks printed {len(done)} done: lines: {done}")
        states = {}
        for label in ("plain", "blocked", "ranks"):
            argv = APP_RANKS_ARGV + (["-load_checkpoint", ck] if label == "ranks" else [])
            with contextlib.redirect_stdout(io.StringIO()):
                ns = app.build(argv)
                if label == "plain":
                    check_solver_stencils(entries, "app 64^2", ns)
                if label == "blocked":
                    ns.impl._dot = blocked_dot(8)
                if label != "ranks":
                    ns.solve()
            assert_finite(ns, f"app 64^2 ({label})")
            states[label] = ns.state
        a = states["plain"]

        def dists(st):
            return {"v": vec_rel_err(st["v"], a["v"]), "U": vec_rel_err(st["U"], a["U"]),
                    "p": rel_err(st["p"], a["p"])}

        got, spread = dists(states["ranks"]), dists(states["blocked"])
        print(f"[launch] app 64^2 f32 on 2x1 ranks, its checkpoint against the one-process "
              f"app run: "
              + ", ".join(f"{k} rel {got[k]:.4e} (the run's dots over 8 row blocks: "
                          f"{spread[k]:.4e}; bound {SPREAD_FACTOR * spread[k]:.4e})"
                          for k in got), flush=True)
        for k in got:
            if not got[k] <= SPREAD_FACTOR * spread[k] < 1.0:
                raise AssertionError(f"the app's ranks vs one process: {k} rel {got[k]:.4e}")
        del states, ns, a
        gc.collect()
        torch.cuda.empty_cache()
    ranks = [r for r in recs if r.get("metric") == "weak_scaling_steps_per_sec"]
    (ici,) = [r for r in recs if "per_rank_bytes_per_step" in r]
    if len(ranks) != 1:
        raise AssertionError(f"bench_scaling on 2 ranks printed {len(ranks)} records")
    ref = ici["reference"]
    print(f"[launch] ici_bytes 256^2 f32 production on {ICI_GRID} ranks: per rank per step "
          f"{ici['per_rank_bytes_per_step']} bytes "
          + ", ".join(f"{k} {v['bytes']} in {v['count']}" for k, v in ici["by_kind"].items())
          + f"; SCALING.md's halo model {ici['scaling_md_halo_model_bytes']}; the "
          f"reference's record ({ref['file']}, its HLO over virtual devices) "
          f"{ref['per_device_bytes_per_step']}, {ref['all_gather_bytes']} of them "
          f"all-gathers", flush=True)
    tb = time.perf_counter()
    # the kernels of the one-process grids at their shapes, for the ledger
    for shape in ((1, 1), (2, 1), (2, 2)):
        ns = bench_scaling.cavity((BENCH_BASE * shape[0], BENCH_BASE * shape[1]),
                                  torch.device("cuda"))
        ns.shard(make_device_grid(2, devices=["cuda"], shape=shape))
        label = f"bench_scaling {ns.mesh.N} on {shape}"
        if shape == (1, 1):
            check_solver_stencils(entries, label, ns)
        else:
            check_sharded_solver(entries, label, ns)
    recs = bench_scaling.one_process(BENCH_BASE, BENCH_STEPS, 4, torch.device("cuda"))
    print(f"[launch] bench_scaling ({smi}; one process --shards 4 in "
          f"{time.perf_counter() - tb:.2f} s, then the launch's 2 ranks): "
          f"{json.dumps(recs + ranks)}", flush=True)
    print(f"[launch] done in {time.perf_counter() - t0:.2f} s", flush=True)


# ----------------------------------------------------------------------
# the bench and probe entry points
# ----------------------------------------------------------------------

# The TPU kernels each probe kernel replaces: the first as "replaces", the
# rest as "also_replaces" (file:line of the function that reaches
# pl.pallas_call).
PROBE_REPLACES = {
    "copy_scale": ("bench.py:139", ["bench.py:542", "examples/probe512.py:27",
                                    "examples/probe512split.py:50",
                                    "examples/probe512split.py:64",
                                    "examples/probe_poisson512.py:110",
                                    "examples/profile512.py:57"]),
    "copy_rolls": ("examples/profile512.py:57", []),
    "poisson3d_variant": ("examples/probe_poisson512.py:65", []),
}
BASELINE5 = (512, 256, 256)
# The sizes the path runs at: the two rooflines' and sharded_1x1_ratio's
# grids (bench.py's), probe512's sweep and momentum shapes, and the grid
# profile512 runs at in the smoke.
SPMV_N, POISSON3D_N = 4096, 256
COPY_CASES = probe512.COPY_CASES
MOMENTUM_SHAPES = probe512.MOMENTUM_SHAPES
PROFILE_GRID = (128, 128, 128)
# Operations per element: the copy 1 (a product), the copy with rolls 4,
# the variants as the Poisson 3-D apply (22) but nocomp (1).
PROBE_FLOPS = {"copy_scale": 1, "copy_rolls": 4, "rebuilt": 22, "noroll": 22, "nocomp": 1}


def copy_shapes():
    """(shape, rows) of every copy_scale launch of the path but the
    profile's: probe512's sweep, spmv_roofline's (128 rows) and
    poisson3d_roofline's (8 rows); probe512split and probe_poisson512 run
    at the sweep's 512x256x256 and 256^3 with 8 rows."""
    return (*((shape, rows) for shape, rows, _ in COPY_CASES), ((SPMV_N,) * 2, 128),
            ((POISSON3D_N,) * 3, 8))


def hold_exact(e, label, got, ref, kernel):
    """A probe kernel's output against its plain version at max abs
    difference 0 (one product by the same float32 factor, or the same
    float32 terms added in the same order with __fmul_rn/__fadd_rn, which
    the compiler does not contract); marks the ledger key."""
    for g, r in zip(got, ref):
        d = max_abs(g, r)
        if d != 0.0:
            raise AssertionError(f"{kernel.name} {label}: max abs {d:.3e} from the plain "
                                 f"version (expected 0)")
    e["checks"] += 1
    kernel.mark_checked()


def variant_inputs(N, gen):
    """Level 0 of the channel of probe_poisson512 at ``N`` (its
    coefficients), a random field and random edges from ``gen``."""
    coeffs = probe_poisson512.channel_level0(N, "cuda").levels[0].coeffs
    p = torch.randn(N, generator=gen, device="cuda")
    edges = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in probes.variant_edge_shapes(N))
    return coeffs, p, edges


def true_edges(p, periodic):
    """The edges that make the variant "rebuilt" the Poisson apply: the
    wrapped rows and columns on a periodic axis, zeros at a wall."""
    def edge(a, idx):
        e = p.narrow(a, idx, 1).contiguous()
        return e if periodic[a] else torch.zeros_like(e)

    return edge(1, p.shape[1] - 1), edge(1, 0), edge(2, p.shape[2] - 1), edge(2, 0)


def check_probes(entries, gen):
    """Each probe kernel against its plain version at every key the
    bench and probe path and the timings launch it at: copy_scale one
    and two pairs at the sweep's shapes and rows, at 256^3 (8 rows) and
    at the profile's grid (8 and 4 rows); copy_rolls at 512x256x256 and
    the profile's grid (8 and 4 rows); the three variants at 512x256x256,
    each at max abs 0, after their launch plan is checked to be the
    apply's; and "rebuilt" with true edges against the Poisson 3-D
    kernel's apply at max abs 0 (the same kernel template and arithmetic,
    poisson3d.cuh)."""
    cases = [*copy_shapes(), (PROFILE_GRID, 8), (PROFILE_GRID, 4)]
    for shape, rows in cases:
        a, b = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
        for arrays in ((a,), (a, b)):
            got = probes.copy_scale(*arrays, rows=rows)
            got = (got,) if len(arrays) == 1 else got
            ref = probes.copy_scale_plain(*arrays)
            ref = (ref,) if len(arrays) == 1 else ref
            hold_exact(entries["copy_scale"], f"{shape} rows {rows} x{len(arrays)}", got, ref,
                       probes.copy_scale)
        del a, b, got, ref
    for shape, rows in ((BASELINE5, 8), (BASELINE5, 4), (PROFILE_GRID, 8), (PROFILE_GRID, 4)):
        a = torch.randn(shape, generator=gen, device="cuda")
        hold_exact(entries["copy_rolls"], f"{shape} rows {rows}",
                   (probes.copy_rolls(a, rows=rows),), (probes.copy_rolls_plain(a),),
                   probes.copy_rolls)
    del a
    coeffs, p, edges = variant_inputs(BASELINE5, gen)
    e = entries["poisson3d_variant"]
    plan, apply_plan = (probes.variant_launch_plan(BASELINE5),
                        cuda_stencil.poisson3d_launch_plan(BASELINE5, torch.float32))
    print(f"[probes] poisson3d_variant at {BASELINE5}: grid {plan.grid}, block (32, "
          f"{plan.rows}), run {plan.run}; the poisson3d apply: grid {apply_plan.grid}, block "
          f"(32, {apply_plan.rows}), run {apply_plan.run}", flush=True)
    if plan != apply_plan:
        raise AssertionError("poisson3d_variant does not launch with the apply's plan")
    # every mode at max abs 0: nocomp is one product by the same float32
    # factor; on this channel's uniform grid every width and band value
    # is a power of two times a small integer (h = 2^-7), so every
    # product is exact and the kernel's fused sums round as the plain
    # version's separate ones (a non-dyadic grid would part by an ulp)
    for mode in probes.VARIANT_MODES:
        got = probes.poisson3d_variant(mode, p, coeffs, edges)
        ref = probes.poisson3d_variant_plain(mode, p, coeffs, edges)
        torch.cuda.synchronize()
        hold_exact(e, f"{mode} {BASELINE5}", (got,), (ref,), probes.poisson3d_variant)
    got = probes.poisson3d_variant("rebuilt", p, coeffs, true_edges(p, coeffs.periodic))
    apply = cuda_stencil.poisson3d("apply", p, coeffs)
    check_kernel(entries["poisson3d"], f"poisson3d apply probe_poisson512 {BASELINE5}",
                 torch.float32, (apply,), (cuda_stencil.poisson3d_plain("apply", p, coeffs),),
                 cuda_stencil.poisson3d)
    d = max_abs(got, apply)
    e["max_abs_vs_poisson3d"] = d
    if d != 0.0:
        raise AssertionError(f"poisson3d_variant rebuilt with true edges differs from the "
                             f"poisson3d apply by {d:.3e}")
    print("[probes] " + "; ".join(f"{k}: {entries[k]['checks']} checks, max abs err "
                                  f"{entries[k]['max_abs_err']:.3e}" for k in PROBE_REPLACES)
          + f"; rebuilt with true edges vs the poisson3d apply: max abs {d:.3e}", flush=True)


def check_probe_path_stencils(entries, ns128):
    """The stencil kernels at the keys only the bench and probe path
    launches: the Poisson 3-D modes on the 256^3 wall level of
    poisson3d_roofline, the Poisson 2-D halo instance on the one-shard
    grid of sharded_1x1_ratio, the momentum kernel at probe512's (512,
    128, 256) channel, and the chain and stencils of the profile's
    channel (its bands have their own fingerprint)."""
    rng = np.random.default_rng(17)
    mesh = CartMesh.create((POISSON3D_N,) * 3)
    mesh.set_uniform_coordinates(0, 1, 0, 1, 0, 1)
    lvl = mg_mod._build_level(mesh, T_.axis_bcs(mesh, [zero_velocity_bc()] * 6), 1.0,
                              torch.float32, "cuda")
    check_poisson_modes(entries["poisson3d"], "poisson3d_roofline", rng, lvl.coeffs,
                        lvl.inv_diag)
    mesh = unit_mesh(SPMV_N, False)
    lvl = mg_mod._build_level(mesh, T_.axis_bcs(mesh, [zero_velocity_bc()] * 4), 1.0,
                              torch.float32, "cuda")
    check_poisson_halo(entries, "sharded_1x1_ratio", make_device_grid(2, ["cuda"]), mesh,
                       lvl.coeffs, lvl.inv_diag, rng)
    del lvl
    gen = torch.Generator(device="cuda").manual_seed(18)
    for N in MOMENTUM_SHAPES:
        bands, f, v = probe512.channel_momentum(N, "cuda", gen)
        got = cuda_stencil.momentum3d(bands, f, v)
        ref = cuda_stencil.momentum3d_plain(bands, f, v)
        torch.cuda.synchronize()
        check_kernel(entries["momentum3d"], f"momentum3d probe512 {N}", torch.float32,
                     got, ref, cuda_stencil.momentum3d)
        del bands, f, v, got, ref
    check_chain_solver(entries, f"profile512 {PROFILE_GRID}", ns128)
    check_solver_stencils(entries, f"profile512 {PROFILE_GRID}", ns128)


def time_probes(entries, gen):
    """Device time (CUDA graph) of each probe kernel, its plain version
    and, for the copy, torch.mul (the one PyTorch call that computes its
    function), beside its bound: every copy shape of the path, copy_rolls
    and the three variants at 512x256x256. The entries take the times at
    512x256x256 (the copy at 8 rows, copy_rolls at 8, the variant
    "rebuilt")."""
    reps = {"calls": 20, "replays": 5, "iters": 20}
    for shape, rows in copy_shapes():
        a = torch.randn(shape, generator=gen, device="cuda")
        n = a.numel()
        t = time_one(f"copy_scale {shape} rows {rows}", lambda: probes.copy_scale(a, rows=rows),
                     lambda: probes.copy_scale_plain(a), nbytes(a, a), n, **reps)
        # the kernel against torch.mul on the same buffer, in turns
        # (library, kernel, kernel, library); the entry takes the means
        turns = [graph_ms(fn, 20, 5) for fn in (lambda: torch.mul(a, probes.SCALE),
                                                lambda: probes.copy_scale(a, rows=rows))]
        turns += [graph_ms(fn, 20, 5) for fn in (lambda: probes.copy_scale(a, rows=rows),
                                                 lambda: torch.mul(a, probes.SCALE))]
        lib_ms, ker_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        t.update(ms=ker_ms, library_ms=lib_ms)
        print(f"[time] copy_scale {shape} rows {rows} against torch.mul in turns: torch.mul "
              f"{turns[0]:.5f}, copy_scale {turns[1]:.5f}, copy_scale {turns[2]:.5f}, torch.mul "
              f"{turns[3]:.5f} ms; copy_scale / torch.mul {ker_ms / lib_ms:.4f}; "
              f"{100 * t['bound_ms'] / ker_ms:.1f} % of 3.35 TB/s", flush=True)
        if shape == BASELINE5 and rows == 8:
            entries["copy_scale"].update(t)
    half = tuple(torch.randn((POISSON3D_N,) * 3, generator=gen, device="cuda")
                 for _ in range(2))
    time_one("copy_scale two 256^3 pairs in one launch rows 8",
             lambda: probes.copy_scale(*half, rows=8), lambda: probes.copy_scale_plain(*half),
             2 * nbytes(*half), 2 * half[0].numel(), **reps)
    del a, half
    a = torch.randn(BASELINE5, generator=gen, device="cuda")
    for rows in (8, 4):
        t = time_one(f"copy_rolls {BASELINE5} rows {rows}",
                     lambda: probes.copy_rolls(a, rows=rows),
                     lambda: probes.copy_rolls_plain(a), nbytes(a, a),
                     PROBE_FLOPS["copy_rolls"] * a.numel(), **reps)
        if rows == 8:
            entries["copy_rolls"].update(t, library_ms=None)
    del a
    coeffs, p, edges = variant_inputs(BASELINE5, gen)
    modes = {}
    for mode in probes.VARIANT_MODES:
        moved = nbytes(p, p) if mode == "nocomp" else nbytes(p, p, *edges, *coeff_tensors(coeffs))
        t = time_one(f"poisson3d_variant {mode} {BASELINE5}",
                     lambda: probes.poisson3d_variant(mode, p, coeffs, edges),
                     lambda: probes.poisson3d_variant_plain(mode, p, coeffs, edges), moved,
                     PROBE_FLOPS[mode] * p.numel(), calls=10, replays=4, iters=10)
        modes[mode] = t["ms"]
        if mode == "rebuilt":
            entries["poisson3d_variant"].update(t, library_ms=None)
    # beside the step's apply and the copy, on the same field in one call
    apply_ms = graph_ms(lambda: cuda_stencil.poisson3d("apply", p, coeffs), 20, 5)
    copy_ms = graph_ms(lambda: probes.copy_scale(p, rows=8), 20, 5)
    print(f"[probes] poisson3d_variant {BASELINE5}: rebuilt / noroll / nocomp "
          f"{modes['rebuilt']:.5f} / {modes['noroll']:.5f} / {modes['nocomp']:.5f} ms beside "
          f"the poisson3d apply {apply_ms:.5f} ms (rebuilt / apply "
          f"{modes['rebuilt'] / apply_ms:.4f}) and copy_scale at 8 rows {copy_ms:.5f} ms "
          f"(nocomp / copy {modes['nocomp'] / copy_ms:.4f})", flush=True)
    entries["poisson3d_variant"].update(apply_ms=apply_ms, copy_ms=copy_ms,
                                        modes_ms=modes)


def phase_probes(entries):
    """The bench and probe entry points on the card: the probe kernels
    checked (check_probes) and the stencils at the path's own keys
    (check_probe_path_stencils); then, with every launch count at 0, the
    path itself: bench.spmv_roofline (4096^2), bench.poisson3d_roofline
    (256^3), bench.sharded_1x1_ratio (4096^2, under its ceiling of 1.15)
    and the host's time per call of its two calls,
    the probe512 sweep and its momentum timings, probe512split,
    probe_poisson512 at 512x256x256 and profile512 at PROFILE_GRID; the
    counts read after it. Then each probe kernel timed. Returns the
    path's launches by kernel instance."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(19)
    check_probes(entries, gen)
    ns128 = profile512.build(PROFILE_GRID, "cuda")
    check_probe_path_stencils(entries, ns128)
    gc.collect()
    torch.cuda.empty_cache()

    cuda_stencil.reset_launch_counts()
    probes.reset_launch_counts()
    r2 = bench.spmv_roofline(N=SPMV_N, device="cuda")
    r3 = bench.poisson3d_roofline(N=POISSON3D_N, device="cuda")
    s = bench.sharded_1x1_ratio(N=SPMV_N, device="cuda")
    host = bench.sharded_1x1_host_us(N=SPMV_N, device="cuda")
    p512 = probe512.run(device="cuda", copy_cases=COPY_CASES, momentum_shapes=MOMENTUM_SHAPES)
    split = probe512split.run(device="cuda", shape=BASELINE5, half=(POISSON3D_N,) * 3)
    pp = probe_poisson512.run(device="cuda", N=BASELINE5)
    prof = profile512.profile(ns128)
    torch.cuda.synchronize()
    launches = {k: n for k, n in cuda_stencil.launch_counts(
        (*cuda_stencil.KERNELS, *probes.KERNELS)).items() if n}
    del ns128
    # the profile's bf16 preconditioner runs all three chain stages
    for name in (*PROBE_REPLACES, "poisson2d", "poisson3d", "poisson2d_halo", "momentum3d",
                 *CHAIN_NAMES):
        if not launches.get(f"{name}_f32"):
            raise AssertionError(f"kernel {name} was not launched by the bench and probe path")
    for label, r in (("spmv_roofline 4096^2", r2), ("poisson3d_roofline 256^3", r3)):
        print(f"[probes] bench.{label}: frac {r['frac']:.4f} (by bench.py's count), copy "
              f"{r['gbps_copy']:.1f} GB/s ({r['copy_frac_peak']:.4f} of 3.35 TB/s), spmv "
              f"{r['gbps_spmv']:.1f} GB/s ({r['spmv_frac_peak']:.4f} of 3.35 TB/s, every "
              f"input), {r['us_per_apply']:.2f} us/apply, copy {r['us_per_copy']:.2f} us",
              flush=True)
    print(f"[probes] bench.sharded_1x1_ratio 4096^2: {s['ratio']:.4f} (ceiling "
          f"{bench.PERF_CEILINGS['sharded_1x1_ratio']}), {s['us_sharded']:.2f} against "
          f"{s['us_unsharded']:.2f} us; the host's time per call (median of 15 x 100 "
          f"calls) {host['us_host_sharded']:.2f} sharded, {host['us_host_unsharded']:.2f} "
          f"unsharded", flush=True)
    if not s["ratio"] <= bench.PERF_CEILINGS["sharded_1x1_ratio"]:
        raise AssertionError(f"sharded_1x1_ratio {s['ratio']} above its ceiling")
    for label, r in (("probe512", p512), ("probe512split", split),
                     ("probe_poisson512", pp), (f"profile512 {PROFILE_GRID}", prof)):
        print(f"[probes] {label}: {json.dumps(r)}", flush=True)
    print(f"[probes] the path's launches: {launches}", flush=True)
    time_probes(entries, gen)
    print(f"[probes] done in {time.perf_counter() - t0:.2f} s", flush=True)
    return launches


def phase_profile(label, ns, cfg=None):
    """Device time by kernel over 3 warm steps of ``ns`` under ``cfg``
    (the production preset if None)."""
    from torch.profiler import ProfilerActivity, profile

    ns.impl.cfg = cfg or CNLinearConfig.production()
    ns.advance(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ns.advance(3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3  # ms
    n_launch = sum(e.count for e in events)
    print(f"[profile] {label}, 3 steps: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * (1 - busy / (wall * 1e3)):.1f}% idle), {n_launch} "
          f"kernel launches", flush=True)
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)


def kernel_entries() -> dict:
    """The kernels line's entry of each stencil kernel instance, the
    chain's stages and the halo instances, before any check."""
    def entry(kernel, replaces, dtypes):
        return {"name": kernel + ("_bf16" if dtypes == (BF16,) else ""),
                "route": "cuda",
                "source": f"fluca_tpu_torch/csrc/{kernel}.cu",
                "replaces": f"fluca_tpu/ops/pallas_stencil.py:{replaces}",
                "max_abs_err": 0.0,
                "max_rel_err": {d: 0.0 for d in dtypes},
                # no one PyTorch call computes these stencils
                "library_ms": None}

    entries = {}
    for dtypes in ((torch.float32, torch.float64), (BF16,)):
        for kernel, replaces in (("poisson2d", 88), ("momentum2d", 595),
                                 ("poisson3d", 324), ("momentum3d", 830)):
            e = entry(kernel, replaces, dtypes)
            entries[e["name"]] = e
    for name in CHAIN_NAMES:
        e = entry("chain3d", 289, (torch.float32, torch.float64))
        # no one PyTorch call computes a stage; the unfused sequence of
        # banded operators is timed beside it (unfused_ms)
        e.update(name=name, replaces="fluca_tpu/ops/pallas_chain3d.py:289", checks=0)
        entries[name] = e
    for kernel, line in HALO_REPLACES.items():
        e = entry(kernel, 0, (torch.float32, torch.float64))
        # the unsharded kernel's time is beside it (unsharded_ms)
        e.update(name=kernel + "_halo", checks=0, max_abs_vs_unsharded=0.0,
                 replaces=f"fluca_tpu/parallel/pallas_sharded.py:{line}")
        entries[e["name"]] = e
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown of 3 steps of "
                         "the 2-D cavity, the 3-D cavity, the 128^3 channel "
                         "(float32 and bf16), both 512x256x256 channel runs, "
                         "the sharded and unsharded runs of phase_sharded, and "
                         "the IBM cells (cylinder, sphere 48x32x32 and 128^3)")
    # one rank of phase_ranks (the script starts its ranks as children)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--case", choices=sorted(RANK_CASES), help=argparse.SUPPRESS)
    ap.add_argument("--ref", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    # one rank of phase_launchers' launch (torch.distributed.run starts it)
    ap.add_argument("--launched", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    if args.launched is not None:
        return launched_main(args)

    t_start = time.perf_counter()
    smi = phase_device()
    resources = start_resource_report()
    phase_build()
    usage = finish_resource_report(resources)

    entries = kernel_entries()
    check_chain_pairs(entries)
    check_poisson(entries["poisson2d"])
    check_momentum(entries["momentum2d"])
    check_poisson_bf16(entries["poisson2d_bf16"])
    check_momentum_bf16(entries["momentum2d_bf16"])
    runs = {dtype: runs3d(dtype, entries) for dtype in (torch.float32, torch.float64)}
    check_poisson3d(entries["poisson3d"], runs)
    check_momentum3d(entries["momentum3d"], runs)
    time_kernels(entries)
    chan = runs[torch.float32][1][1]
    t32 = time_kernels3d("128^3", chan, torch.float32)
    entries["poisson3d"].update(t32["apply"])
    entries["momentum3d"].update(t32["momentum"])
    for name, t in time_chain("128^3", chan).items():
        entries[name].update(t)
    t16 = time_kernels3d("128^3", chan, BF16)
    entries["poisson3d_bf16"].update(t16["apply"])
    entries["momentum3d_bf16"].update(t16["momentum"])
    time_momentum3d_halo(entries, "channel 128^3", chan)
    del runs, chan
    launches, cpu256 = phase_slice(smi)
    launches_bf16 = phase_slice_bf16(smi, cpu256)
    phase_budget_bf16(entries)
    phase_inner_bf16(entries)
    phase_app(entries)
    launches3d, launches3d_bf16 = phase_slice3d(smi, entries)
    phase_chain_ab(entries)
    phase_channel512(smi, entries, profile=args.profile)
    phase_channel512_bf16(smi, entries, profile=args.profile)
    phase_app3d(entries)
    ibm_runs, sphere128_figures = phase_ibm(smi, entries)
    accuracy_runs = {}
    tolerance_figures = phase_tolerance(smi, entries, accuracy_runs)
    turb_figures = phase_turb(smi, entries, accuracy_runs)
    fd_figures = phase_fd()
    launches_halo2d, launches_halo3d = phase_sharded(smi, entries, profile=args.profile)
    phase_ranks(smi, entries)
    phase_launchers(smi, entries)
    probe_entries = {}
    for name, (replaces, also) in PROBE_REPLACES.items():
        probe_entries[name] = {"name": name, "route": "cuda",
                               "source": "fluca_tpu_torch/csrc/probes.cu",
                               "replaces": replaces, "also_replaces": also,
                               "max_abs_err": 0.0, "max_rel_err": {torch.float32: 0.0},
                               "checks": 0}
    probe_launches = phase_probes({**entries, **probe_entries})
    for name, e in probe_entries.items():
        e.update(launches=probe_launches[f"{name}_f32"],
                 launches_run="the bench and probe entry points (phase_probes)",
                 shape="512x256x256")
    for name in (*CHAIN_NAMES, *(k + "_halo" for k in HALO)):
        report(name, entries[name]["checks"], entries[name])
    for k in HALO:
        print(f"[sharded] {k}_halo: max abs difference from the unsharded kernel "
              f"{entries[k + '_halo']['max_abs_vs_unsharded']:.3e} over "
              f"{entries[k + '_halo']['checks']} checks", flush=True)
    if args.profile:
        phase_profile("cavity 256^2",
                      setup_cavity_2d(N=256, Re=100.0, dt=0.01, device="cuda"))
        phase_profile("cavity 64x64x32", setup_cavity_3d(
            N=(64, 64, 32), Re=100.0, dt=0.01, device="cuda"))
        phase_profile("channel 128^3", setup_channel_3d(
            N=(128, 128, 128), dt=2e-3, device="cuda"))
        phase_profile("channel 128^3 bf16 (both)", setup_channel_3d(
            N=(128, 128, 128), dt=2e-3, device="cuda"),
            bf16_precond(CNLinearConfig.production()))
        # the IBM cells of phase_ibm, float32, production(3, 8, 8)
        for label, setup, kw, ckpt in (
                ("cylinder 176x88 f32", setup_cylinder_2d, CYLINDER, CYLINDER_CKPT),
                ("sphere 48x32x32 f32", setup_sphere_3d, SPHERE48, SPHERE48_CKPT),
                ("sphere 128^3 f32", setup_sphere_3d, SPHERE128, None)):
            ns, _ = ibm_solver(setup, kw, torch.float32, ckpt)
            phase_profile(label, ns, ns.impl.cfg)
    # each instance's launches in the main-path run that carries it: both
    # instances of a kernel from the same cell, the float32 and the bf16
    # preconditioner's run, at the shape of the kernel's times
    runs = {"2d": ("256x256", "cavity 256^2, 21 steps", 21, launches),
            "2d_bf16": ("256x256", "cavity 256^2 bf16 (both), 21 steps", 21,
                        launches_bf16),
            "3d": ("128x128x128", "channel 128^3, 11 steps", 11, launches3d),
            "3d_bf16": ("128x128x128", "channel 128^3 bf16 (both), 11 steps", 11,
                        launches3d_bf16),
            "2d_halo": ("256x256", "cavity 256^2 on (4, 2), 21 steps", 21,
                        launches_halo2d),
            "3d_halo": ("512x256x256", "channel 512x256x256 on (2, 2, 2), 11 steps", 11,
                        launches_halo3d)}
    for name, e in entries.items():
        shape, run, steps, counts = runs[("3d" if "3d" in name else "2d")
                                         + ("_bf16" if name.endswith("_bf16") else "")
                                         + ("_halo" if name.endswith("_halo") else "")]
        e.update(shape=shape, launches_run=run, launches=counts[name],
                 launches_per_step=round(counts[name] / steps, 2))
    # each kernel's launches per step in the IBM runs (phase_ibm), all
    # instances of the run's dtype
    for name, e in entries.items():
        e["launches_ibm"] = {run: c[name] for run, c in ibm_runs.items() if name in c}
    print(f"[ibm] launches per step by run: {json.dumps(ibm_runs)}; sphere 128^3: "
          f"{json.dumps(sphere128_figures)}", flush=True)
    # and in the accuracy-contract and turbulence runs
    for name, e in entries.items():
        e["launches_accuracy"] = {run: c[name] for run, c in accuracy_runs.items()
                                  if name in c}
    turb_figures.pop("series")
    print(f"[tolerance] launches per step by run: {json.dumps(accuracy_runs)}; outer "
          f"iterations and the production step: {json.dumps(tolerance_figures)}; turb: "
          f"{json.dumps(turb_figures)}; fd: {json.dumps(fd_figures)}", flush=True)
    entries.update(probe_entries)
    for label, u in usage.items():
        if label in entries:
            entries[label].update(u)
    phase_ledger()
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "launches_run",
            "launches_per_step", "shape",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "unfused_ms", "unfused_launches", "kernels_ms", "unsharded_ms",
            "max_abs_vs_unsharded", "also_replaces", "max_abs_vs_poisson3d", "registers",
            "spill_bytes", "at_4096", "launches_ibm", "launches_accuracy", "modes_ms",
            "apply_ms", "copy_ms", "launches_ranks", "max_abs_vs_one_card")
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e}
                                  for e in entries.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
