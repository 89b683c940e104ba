"""Hand-written CUDA kernels for the stencils of the NS step.

Counterpart of fluca_tpu.ops.pallas_stencil and
fluca_tpu.ops.pallas_chain3d for the kernels the 2-D and 3-D time steps
run:

- the fused pressure-Poisson stencil in 2-D and 3-D
  (``poisson2d_raw_call`` and ``poisson3d_raw_call`` there) in its
  apply, residual and damped-Jacobi smooth modes, called on every
  multigrid level and by every Schur CG iteration;
- the fused momentum A-apply in 2-D and 3-D (``momentum2d_raw_call``
  and ``momentum3d_raw_calls`` there), called by every momentum sweep
  and every coupled apply;
- the fused 3-D interp/div/grad chain (``Chain3D._build`` there) in
  its three stages (coupled, ABF pre, ABF post), called by every
  coupled apply and every ABF application of the 3-D step, through
  ``ops/chain3d.py``'s ``Chain3D``;
- the halo instances of the four stencils (``*_halo``), the
  counterparts of fluca_tpu.parallel.pallas_sharded's wrappers: the
  same kernels on the shards of a device grid, one launch per shard,
  through ``parallel/sharded.py``.

The CUDA sources live in ``fluca_tpu_torch/csrc``. They are compiled on
first use with ``nvcc`` for ``sm_90a`` (one process per source, in
parallel) into a shared library with a plain C interface, under ``build/fluca_tpu_torch/<source hash>/`` at the root
of the checkout, and loaded with ctypes. The library also holds the
bench's and the probes' kernels (``csrc/probes.cu``, wrapped by
``ops/probes.py``).

Each stencil kernel has three instances: float32 and float64
(fields, coefficients and arithmetic in one type), and bfloat16 for the
reduced-precision ABF preconditioner (``precond_dtype``): bf16 fields,
coefficient arrays and arithmetic in ``coef_dtype`` (float32), one
rounding at the store, as the TPU kernels' bf16 instances
(``pallas_stencil._coef_dtype``). The chain runs in the solver dtype
only, float32 or float64: the bf16 branch of the ABF preconditioner
never calls it (fluca_tpu/ns/cnlinear.py:685-724).

Each kernel has a plain PyTorch version of the same function beside
it, built from ``shifted`` on the same coefficient arrays, with the
same bf16 semantics (fields upcast to the coefficients' dtype, result
rounded to the fields'). A wrapper takes the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. Each wrapper counts its kernel launches in ``launches``, and
by instance in ``launches_by_dtype``, and keeps a ledger: the set of
(shape, instance, band set) keys it launched at (``launched``) and the
keys a comparison with the plain version covered (``checked``, marked by
``mark_checked`` after such a comparison).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from fluca_tpu_torch.ops.banded import broadcast_1d, shifted
from fluca_tpu_torch.parallel.mesh import DeviceGrid

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("poisson2d.cu", "momentum2d.cu", "poisson3d.cu", "momentum3d.cu",
           "chain3d.cu", "probes.cu")
HEADERS = ("stencil_common.cuh", "poisson3d.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libfluca_tpu_torch_kernels.so"

_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
                 torch.bfloat16: "bf16"}
POISSON_MODES = {"apply": 0, "residual": 1, "smooth": 2}
# The CUDA grid's y extent (one block row per 8 rows of the field).
_MAX_ROWS = 65535 * 8
# The CUDA grid's y and z extents.
_MAX_PLANES = 65535


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------

def build_dir() -> Path:
    """``build/fluca_tpu_torch`` at the root of the checkout."""
    return CSRC_DIR.parents[1] / "build" / "fluca_tpu_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels cannot be built"
        )
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_nvcc(cmds) -> None:
    """Run the nvcc commands all at once and wait for every one; raise
    with the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")


def build_library() -> Path:
    """Compile the kernels unless a library built from the same sources
    exists; returns its path. Each source compiles in its own nvcc
    process, all started together, and the objects link into one
    library. The compiler's output goes to a temporary directory first,
    so a cut build leaves no library behind."""
    out_dir = build_dir() / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, f"{Path(s).stem}.o") for s in SOURCES]
        _run_nvcc([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", o,
                    str(CSRC_DIR / s)] for s, o in zip(SOURCES, objs)])
        so = os.path.join(tmp, LIB_NAME)
        _run_nvcc([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]])
        os.replace(so, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process.
    Each wrapper sets the argument types of its entry points
    (``_Kernel._entry``)."""
    return ctypes.CDLL(str(build_library()))


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PP, _PL = ctypes.POINTER(_VP), ctypes.POINTER(ctypes.c_longlong)
# the pointer arrays of the 2-D kernels' entry points
_PTRS8, _PTRS5 = _VP * 8, _VP * 5
# the C interface of the momentum 3-D kernel and the chain stages: an
# array of device pointers, the three extents, the three periodicity
# flags, the launch plan and the stream
_PTRS_3D = [ctypes.POINTER(_VP), _CI, _CI, _CI, _CI, _CI, _CI, ctypes.POINTER(_CI), _VP]


def _check_cuda(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ----------------------------------------------------------------------
# argument checks shared by the wrappers
# ----------------------------------------------------------------------

def coef_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a kernel instance's coefficient arrays and
    arithmetic for fields of ``dtype``: float32 for fields narrower than
    32 bits (bf16), else the field dtype (pallas_stencil._coef_dtype)."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def _check_tensors(name, ref, fields, coeffs=None):
    """Every tensor on ``ref``'s device and contiguous; the fields in
    ``ref``'s dtype, the coefficient arrays in its ``coef_dtype``."""
    if ref.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported "
                        f"(float32, float64 or bfloat16)")
    want = {label: (t, ref.dtype) for label, t in fields.items()}
    want.update((label, (t, coef_dtype(ref.dtype)))
                for label, t in (coeffs or {}).items())
    for label, (t, dtype) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {label} is not a tensor")
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} on {t.device}, "
                             f"expected {ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")


def _check_coeff_dtype(name, t):
    """Coefficient arrays are float32 or float64: no instance takes
    bf16 coefficients."""
    if t.dtype not in _DTYPE_SUFFIX or coef_dtype(t.dtype) != t.dtype:
        raise TypeError(f"{name}: coefficients in {t.dtype}, expected "
                        f"float32 or float64")


def _launch_target(name, x) -> str:
    """'cpu' -> the plain version; 'cuda' -> the kernel; anything else
    is refused."""
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {x.device} but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    return "cuda"


def _stream_ptr(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


class _Kernel:
    """Launch bookkeeping shared by the wrappers: the C entry point of
    the fields' instance, the error check, the launch counts, and the
    ledger of launched and checked (shape, instance, band set) keys. The
    counts are reset by ``reset``; the ledger spans the process."""

    name = ""
    # the field dtypes the kernel has an instance for, and the ctypes
    # argument types of its entry points
    instances = tuple(_DTYPE_SUFFIX.values())
    argtypes = ()

    def __init__(self):
        self.launched = set()
        self.checked = set()
        self.last_key = None
        self._fns = {}
        self.reset()

    def reset(self) -> None:
        self.launches_by_dtype = dict.fromkeys(_DTYPE_SUFFIX.values(), 0)

    @property
    def launches(self) -> int:
        """The launches of all instances."""
        return sum(self.launches_by_dtype.values())

    def _launch(self, dtype, key, *args) -> None:
        """Launch the ``dtype`` instance with ``args``; ``key`` is the
        (shape, band set) pair the ledger records with the instance."""
        sfx = _DTYPE_SUFFIX[dtype]
        _check_cuda(self.name, self._entry(sfx)(*args))
        self.launches_by_dtype[sfx] += 1
        self.last_key = (key[0], sfx, key[1])
        self.launched.add(self.last_key)

    def _entry(self, sfx):
        """The C entry point of instance ``sfx``, with its argument
        types set at first use."""
        fn = self._fns.get(sfx)
        if fn is None:
            fn = getattr(load_library(), f"fluca_{self.name}_{sfx}")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[sfx] = fn
        return fn

    def mark_checked(self) -> None:
        """Record the last launch's key as held against the plain
        version (called by a check after its comparison passed)."""
        if self.last_key is None:
            raise RuntimeError(f"{self.name}: no launch to mark as checked")
        self.checked.add(self.last_key)

    def unchecked(self) -> set:
        """The launched keys no check covered."""
        return self.launched - self.checked

    @property
    def source(self) -> str:
        """The kernel's CUDA source in ``CSRC_DIR``."""
        return f"{self.name}.cu"


# ----------------------------------------------------------------------
# Poisson 2-D
# ----------------------------------------------------------------------

def _tridiagonal(st, n):
    """The (-1, 0, +1) bands of a host D@Gst AxisStencil of length n."""
    out = st.as_dict()
    if not set(out) <= {-1, 0, 1}:
        raise ValueError(f"D@Gst is not tridiagonal: offsets {set(out)}")
    z = np.zeros(n)
    return out.get(-1, z), out.get(0, z), out.get(1, z)


def _poisson_fields(name, mode, p, b, w, ndim):
    """Check the mode's arguments; returns the fields the mode reads."""
    if mode not in POISSON_MODES:
        raise ValueError(f"{name}: unknown mode {mode!r}")
    need = {"apply": (), "residual": ("b",), "smooth": ("b", "w")}[mode]
    given = {"b": b, "w": w}
    for k in ("b", "w"):
        if (k in need) != (given[k] is not None):
            raise ValueError(
                f"{name}: mode {mode!r} takes "
                f"{'p, ' + ', '.join(need) if need else 'p'}"
            )
    if not isinstance(p, torch.Tensor) or p.dim() != ndim:
        raise ValueError(f"{name}: p must be a {ndim}-D tensor")
    fields = {"p": p}
    for k in need:
        t = given[k]
        if not isinstance(t, torch.Tensor) or t.shape != p.shape:
            raise ValueError(f"{name}: {k} must have shape {tuple(p.shape)}")
        fields[k] = t
    return fields


def poisson2d_coeffs(mesh, host_dgst, host_vol):
    """Host-precomputed separable coefficient arrays (numpy float64)
    RX (3, N0), RY (N0,), CY (N1,), CYb (3, N1) for the operator
    Shat p = vol .* (-(D Gst) p), vol = scale * cell volumes
    (counterpart of pallas_stencil.poisson2d_coeffs):

      Shat p [i,j] = CY[j] * sum_o RX[o,i] p[i+o,j]
                   + RY[i] * sum_o CYb[o,j] p[i,j+o]

    ``host_dgst`` are the per-axis composed D@Gst AxisStencils and
    ``host_vol`` the (N0, N1) array scale * cell volumes."""
    N0, N1 = mesh.N
    bx = _tridiagonal(host_dgst[0], N0)
    by = _tridiagonal(host_dgst[1], N1)
    hy = mesh.widths(1)
    volrow = np.asarray(host_vol)[:, 0] / hy[0]  # = scale * hx
    RX = np.stack([-volrow * b for b in bx], 0)
    CY = hy
    RY = volrow
    CYb = np.stack([-hy * b for b in by], 0)
    return RX, RY, CY, CYb


@dataclass(frozen=True)
class Poisson2DCoeffs:
    """Device copies of the ``poisson2d_coeffs`` arrays for one grid
    level, with the level's periodicity, in a coefficient dtype (float32
    or float64); checked once when built."""

    rx: torch.Tensor  # (3, N0)
    ry: torch.Tensor  # (N0,)
    cy: torch.Tensor  # (N1,)
    cyb: torch.Tensor  # (3, N1)
    periodic: tuple[bool, bool]

    def __post_init__(self):
        if self.ry.dim() != 1 or self.cy.dim() != 1 \
                or self.rx.shape != (3, self.ry.shape[0]) \
                or self.cyb.shape != (3, self.cy.shape[0]):
            raise ValueError(f"poisson2d coefficients: rx {tuple(self.rx.shape)}, ry "
                             f"{tuple(self.ry.shape)}, cy {tuple(self.cy.shape)}, cyb "
                             f"{tuple(self.cyb.shape)}")
        _check_coeff_dtype("poisson2d coefficients", self.rx)
        _check_tensors("poisson2d coefficients", self.rx, {
            "rx": self.rx, "ry": self.ry, "cy": self.cy, "cyb": self.cyb})

    @classmethod
    def from_host(cls, arrays, periodic, dtype, device):
        return cls(*(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
                     for a in arrays), (bool(periodic[0]), bool(periodic[1])))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ry.shape[0], self.cy.shape[0])


def _upcast(dtype, *xs):
    """The tensors among ``xs`` in ``dtype`` (None stays None)."""
    return tuple(None if x is None else x.to(dtype) for x in xs)


def poisson2d_plain(mode, p, c: Poisson2DCoeffs, b=None, w=None,
                    omega=0.0):
    """Plain PyTorch version of the Poisson 2-D kernel (same function,
    same coefficient arrays): computed in the coefficients' dtype,
    returned in the fields'."""
    out_dtype = p.dtype
    p, b, w = _upcast(c.rx.dtype, p, b, w)
    return _poisson2d(mode, p, c, b, w, omega, _global_shift(p, c.periodic)).to(out_dtype)


def _global_shift(x, periodic):
    """sh(axis, off): ``x`` shifted with ``shifted``'s semantics."""
    return lambda a, off: shifted(x, a, off, x.shape[a], periodic[a])


def _poisson2d(mode, p, c, b, w, omega, sh):
    """The Poisson 2-D function with the neighbour reads of p from
    ``sh(axis, off)``: shared by the plain and the halo plain version."""
    x = (
        c.rx[0][:, None] * sh(0, -1)
        + c.rx[1][:, None] * p
        + c.rx[2][:, None] * sh(0, 1)
    ) * c.cy[None, :]
    y = c.ry[:, None] * (
        c.cyb[0][None, :] * sh(1, -1)
        + c.cyb[1][None, :] * p
        + c.cyb[2][None, :] * sh(1, 1)
    )
    return _poisson_mode(mode, x + y, p, b, w, omega)


def _poisson_mode(mode, sp, p, b, w, omega):
    """Sp | b - Sp | p + omega w (b - Sp), by mode."""
    if mode == "apply":
        return sp
    if mode == "residual":
        return b - sp
    return p + omega * w * (b - sp)


class Poisson2DKernel(_Kernel):
    """Wrapper of the Poisson 2-D kernel (csrc/poisson2d.cu)."""

    name = "poisson2d"
    argtypes = [_CI, _PP, _CI, _CI, _CI, _CI, ctypes.c_double, ctypes.POINTER(_CI), _VP]

    def __call__(self, mode, p, c: Poisson2DCoeffs, b=None, w=None,
                 omega=0.0):
        fields = _poisson_fields(self.name, mode, p, b, w, 2)
        N0, N1 = p.shape
        if c.shape != (N0, N1):
            raise ValueError(f"{self.name}: coefficients for {c.shape}, "
                             f"field {tuple(p.shape)}")
        # the coefficient arrays share rx's dtype and device (checked when
        # they were built)
        _check_tensors(self.name, p, fields, {"rx": c.rx})
        if _launch_target(self.name, p) == "cpu":
            return poisson2d_plain(mode, p, c, b, w, omega)
        out = torch.empty_like(p)
        fp = (p.data_ptr(), b if b is None else b.data_ptr(),
              w if w is None else w.data_ptr(), out.data_ptr())
        plan = poisson2d_launch_plan((N0, N1), p.dtype, _aligned(fp))
        self._launch(p.dtype, ((N0, N1), c.periodic), POISSON_MODES[mode],
                     _PTRS8(*fp[:3], c.rx.data_ptr(), c.ry.data_ptr(), c.cy.data_ptr(),
                            c.cyb.data_ptr(), fp[3]),
                     N0, N1, int(c.periodic[0]), int(c.periodic[1]), float(omega),
                     plan.as_c(), _stream_ptr(p))
        return out


poisson2d = Poisson2DKernel()


# ----------------------------------------------------------------------
# Momentum 2-D
# ----------------------------------------------------------------------

MOMENTUM_PLANES = 26


def momentum2d_plain(W, u, v, periodic):
    """Plain PyTorch version of the momentum 2-D kernel: A (u, v) from
    the (26, N0, N1) plane stack of
    NSOperators.build_momentum_coeffs_stacked, computed in the
    ``coef_dtype`` of the fields' dtype and returned in the fields'."""
    out_dtype = u.dtype
    W, u, v = _upcast(coef_dtype(u.dtype), W, u, v)
    out = _momentum2d(W, u, v, _global_shift(u, periodic), _global_shift(v, periodic))
    return tuple(x.to(out_dtype) for x in out)


def _momentum2d(W, u, v, su, sv):
    """The momentum 2-D function with the neighbour reads of u and v
    from ``su(axis, off)`` and ``sv(axis, off)``: shared by the plain and
    the halo plain version."""
    out_u = (
        W[0] * su(0, -1) + W[1] * u + W[2] * su(0, 1)
        + W[3] * su(1, -1) + W[4] * u + W[5] * su(1, 1)
        + W[6] * sv(1, -1) + W[7] * v + W[8] * sv(1, 1)
        + W[18] * su(0, -2) + W[19] * su(0, 2)
        + W[20] * su(1, -2) + W[21] * su(1, 2)
    )
    out_v = (
        W[9] * sv(0, -1) + W[10] * v + W[11] * sv(0, 1)
        + W[12] * sv(1, -1) + W[13] * v + W[14] * sv(1, 1)
        + W[15] * su(0, -1) + W[16] * u + W[17] * su(0, 1)
        + W[22] * sv(0, -2) + W[23] * sv(0, 2)
        + W[24] * sv(1, -2) + W[25] * sv(1, 2)
    )
    return out_u, out_v


class Momentum2DKernel(_Kernel):
    """Wrapper of the momentum 2-D kernel (csrc/momentum2d.cu). The
    plane stack is in the fields' dtype."""

    name = "momentum2d"
    argtypes = [_PP, _CI, _CI, _CI, _CI, ctypes.POINTER(_CI), _VP]

    def __call__(self, W, u, v, periodic):
        if not isinstance(u, torch.Tensor) or u.dim() != 2:
            raise ValueError(f"{self.name}: u must be a 2-D tensor")
        N0, N1 = u.shape
        if not isinstance(v, torch.Tensor) or v.shape != u.shape:
            raise ValueError(f"{self.name}: v must have shape {(N0, N1)}")
        if not isinstance(W, torch.Tensor) or \
                W.shape != (MOMENTUM_PLANES, N0, N1):
            raise ValueError(f"{self.name}: W must have shape "
                             f"{(MOMENTUM_PLANES, N0, N1)}")
        _check_tensors(self.name, u, {"W": W, "u": u, "v": v})
        per0, per1 = (bool(x) for x in periodic)
        if _launch_target(self.name, u) == "cpu":
            return momentum2d_plain(W, u, v, (per0, per1))
        out_u = torch.empty_like(u)
        out_v = torch.empty_like(v)
        ptrs = (W.data_ptr(), u.data_ptr(), v.data_ptr(), out_u.data_ptr(),
                out_v.data_ptr())
        plan = momentum2d_launch_plan((N0, N1), u.dtype, _aligned(ptrs))
        self._launch(u.dtype, ((N0, N1), (per0, per1)), _PTRS5(*ptrs), N0, N1,
                     int(per0), int(per1), plan.as_c(), _stream_ptr(u))
        return out_u, out_v


momentum2d = Momentum2DKernel()


# ----------------------------------------------------------------------
# The launch plans of the 2-D kernels
# ----------------------------------------------------------------------
#
# csrc/poisson2d.cu and csrc/momentum2d.cu march along axis 0: a block of
# 32 x ``rows`` threads, one strip of columns per warp, walks ``run`` rows;
# each lane holds ``vec`` cells of a row, read as one access, and the
# lanes at each end of a warp hold the ``reach`` columns past its strip
# (the neighbours the other lanes take with shuffles) and compute nothing
# (csrc/stencil_common.cuh Lane2D). The host picks the geometry (cached
# per shape, dtype and alignment) and the C entry points check it against
# the shape and the addresses: a plan that does not tile the block is
# refused, never relaunched.

LANES = 32  # the threads of a warp


@dataclass(frozen=True)
class March2DPlan:
    """One launch of a 2-D marching kernel: the grid (column tiles of
    ``rows`` strips, runs), the warps of a block (its y extent), the rows
    of a run, the cells per lane and the dynamic shared memory."""

    grid: tuple[int, int]
    rows: int
    run: int
    vec: int
    smem: int

    def as_c(self):
        """The plan as the C entry points take it (6 ints), built once."""
        return self._c

    @functools.cached_property
    def _c(self):
        return (ctypes.c_int * 6)(*self.grid, self.rows, self.run, self.vec, self.smem)


def march2d_columns(reach, vec) -> int:
    """The columns a warp computes: its lanes less ``ceil(reach / vec)``
    at each end, ``vec`` cells each (Lane2D::kCols)."""
    return (LANES - 2 * -(-reach // vec)) * vec


def _aligned(addresses) -> bool:
    """Every address among ``addresses`` (None: no tensor) a multiple of
    16 bytes: the kernels read and write 16 bytes of cells at a time only
    then."""
    bits = 0
    for a in addresses:
        bits |= a or 0
    return bits & 15 == 0


def _march2d_plan(name, shape, reach, vec, warps, runs, target_blocks,
                  smem_of_run) -> March2DPlan:
    """A 2-D march over a block of ``shape`` cells whose stencil reaches
    ``reach`` columns to each side, with at most ``vec`` cells per lane
    (fewer where the row length needs it) and ``warps`` warps per block
    (fewer where a row has fewer strips); ``run`` about n0 * column tiles
    / ``target_blocks``, kept within ``runs`` and the axis and evened out
    over the rows, so that shapes with fewer than twice the target's
    rows and tiles (the coarse levels) take one row per block. Raises
    where the shape does not fit the CUDA grid."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"{name}: no launch for the shape {shape}")
    n0, n1 = shape
    while n1 % vec:
        vec //= 2
    strips = -(-n1 // march2d_columns(reach, vec))
    rows = min(warps, strips)
    gx = -(-strips // rows)
    lo, hi = runs
    run = min(n0, max(lo, min(hi, n0 * gx // target_blocks)))
    gy = -(-n0 // run)
    run = -(-n0 // gy)
    smem = smem_of_run(run)
    if gy > _MAX_PLANES or gx >= 2**31 or smem > 48 * 1024:
        raise ValueError(f"{name}: the shape {shape} does not fit the card "
                         f"(grid {(gx, gy)}, {smem} bytes of shared memory)")
    return March2DPlan((gx, gy), rows, run, vec, smem)


# The launch geometry of csrc/poisson2d.cu: up to POISSON2D_WARPS warps per
# block, POISSON2D_VEC cells per lane (where the rows and addresses are
# aligned to them), runs of about n0 * tiles / POISSON2D_TARGET_BLOCKS rows
# within POISSON2D_RUNS. On the H100 at 4096^2 (examples/kernels2d.py
# --plans, PERF.md section 6) f32, f64 and bf16 all ran fastest at runs of
# 4 rows (8: 1-6 % slower) and 16 bytes per lane in f32 and f64, 8 in bf16
# (4 cells: 16 bytes were within 0-4 %); warps 2-4 within 1 %, and at 256^2
# 4 warps beat 1 by 18-45 % (fewer, larger blocks: the coarse levels keep
# them, one row each, even below one block per SM). Where the
# runs are one row (up to ~512^2: the launch is bound by its latency) half
# those cells per lane: at 256^2 f32 the residual and smooth ran 6-12 %
# faster at 2 cells than at 4. A block stages RX's three values and RY per
# row of its run in shared memory, but for a one-row run, which reads them
# with its row.
POISSON2D_WARPS = 4
POISSON2D_VEC = {torch.float32: 4, torch.float64: 2, torch.bfloat16: 4}
POISSON2D_RUNS = (1, 4)
POISSON2D_TARGET_BLOCKS = 1024


@functools.lru_cache(maxsize=None)
def poisson2d_launch_plan(shape, dtype, aligned=True) -> March2DPlan:
    """The launch of the Poisson 2-D kernel on a block of ``shape`` cells
    (the grid, or one shard's block) with fields in ``dtype``; one cell
    per lane unless the fields' addresses are ``aligned`` to 16 bytes:
    every cell computed by exactly one thread. Raises where the shape
    does not fit the CUDA grid."""
    item = coef_dtype(dtype).itemsize

    def plan(vec):
        return _march2d_plan("poisson2d", shape, 1, vec, POISSON2D_WARPS, POISSON2D_RUNS,
                             POISSON2D_TARGET_BLOCKS, lambda run: 4 * item * run)

    out = plan(POISSON2D_VEC[dtype] if aligned else 1)
    # runs of one row (the small levels) are bound by their latency: half
    # the cells per lane, half the chain of each thread
    return plan(out.vec // 2) if out.run == 1 and out.vec > 1 else out


# The launch geometry of csrc/momentum2d.cu: as the Poisson kernel's, with
# the +-2 reach (two end lanes per warp at one cell per lane) and no
# shared memory. On the H100 at 4096^2 runs of one row were the fastest in
# f32 and bf16 (runs of 4 4-6 % slower, of 32 20-31 %: the 26 plane streams
# dominate the traffic and the re-read rows of u and v come from L2), one
# cell per lane in f32, two in f64 (16 bytes) and four in bf16 (8 bytes)
# (examples/kernels2d.py --plans).
MOMENTUM2D_WARPS = 4
MOMENTUM2D_VEC = {torch.float32: 1, torch.float64: 2, torch.bfloat16: 4}


@functools.lru_cache(maxsize=None)
def momentum2d_launch_plan(shape, dtype, aligned=True) -> March2DPlan:
    """The launch of the momentum 2-D kernel on a block of ``shape``
    cells with fields in ``dtype``, as ``poisson2d_launch_plan``, one row
    per block."""
    return _march2d_plan("momentum2d", shape, 2, MOMENTUM2D_VEC[dtype] if aligned else 1,
                         MOMENTUM2D_WARPS, (1, 1), 1, lambda run: 0)


# ----------------------------------------------------------------------
# The launch plans of the 3-D kernels
# ----------------------------------------------------------------------
#
# csrc/momentum3d.cu, csrc/poisson3d.cu and csrc/chain3d.cu march along
# axis 0: a block of 32 x ``rows`` threads owns a (rows x 32) tile of
# the (j, k) plane and walks ``run`` planes, one index per thread, with
# the neighbours along axis 0 in a register ring. The host picks the
# geometry (cached per shape) and the C entry points check it against
# the shape: a plan that does not tile the box is refused, never
# relaunched.

MARCH_LANES = 32  # kLanes of the marching kernels: threads of a block along k
# a block's dynamic shared memory
MAX_SMEM_BYTES = 232448


@dataclass(frozen=True)
class MarchPlan:
    """One launch of a kernel that marches along axis 0 (csrc/momentum3d.cu,
    csrc/poisson3d.cu, csrc/chain3d.cu): the grid (k tiles, j tiles,
    runs), the block's rows (its y extent; 32 threads along k), the
    planes of a run and the dynamic shared memory."""

    grid: tuple[int, int, int]
    rows: int
    run: int
    smem: int

    def as_c(self):
        return (ctypes.c_int * 6)(*self.grid, self.rows, self.run, self.smem)


def _march_plan(name, shape, rows, runs, target_blocks, smem_of_run) -> MarchPlan:
    """A block of 32 x ``rows`` threads per (rows x 32) tile of the (j, k)
    plane of a box of ``shape`` indices, marching along axis 0: ``run``
    about n0 * tiles / ``target_blocks``, kept within ``runs`` and the
    axis and evened out over the planes. Raises where the shape does not
    fit the CUDA grid or the shared memory."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"{name}: no launch for the shape {shape}")
    n0, n1, n2 = shape
    gx, gy = -(-n2 // MARCH_LANES), -(-n1 // rows)
    lo, hi = runs
    run = min(n0, max(lo, min(hi, n0 * gx * gy // target_blocks)))
    gz = -(-n0 // run)
    run = -(-n0 // gz)
    smem = smem_of_run(run)
    if gy > _MAX_PLANES or gz > _MAX_PLANES or gx >= 2**31 or smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: the shape {shape} does not fit the card "
                         f"(grid {(gx, gy, gz)}, {smem} bytes of shared memory)")
    return MarchPlan((gx, gy, gz), rows, run, smem)


# ----------------------------------------------------------------------
# Poisson 3-D
# ----------------------------------------------------------------------

def poisson3d_coeffs(mesh, host_dgst, host_vol):
    """Host-precomputed separable coefficient arrays (numpy float64)
    A0 (3, N0), C1 (3, N1), C2 (3, N2), H0 (N0,), H1 (N1,), H2 (N2,)
    for the operator Shat p = vol .* (-(D Gst) p), vol = scale * cell
    volumes (counterpart of pallas_stencil.poisson3d_coeffs, with 1-D
    arrays in place of its (N1, N2) planes):

      Shat p [i,j,k] = H1[j] H2[k] sum_o A0[o,i] p[i+o,j,k]
                     + H0[i] (H2[k] sum_o C1[o,j] p[i,j+o,k]
                              + H1[j] sum_o C2[o,k] p[i,j,k+o])

    with H the cell widths and A0, C1, C2 the 1-D D@Gst bands times
    -scale * width. ``host_dgst`` are the per-axis composed D@Gst
    AxisStencils and ``host_vol`` the (N0, N1, N2) array scale * cell
    volumes."""
    h = [mesh.widths(d) for d in range(3)]
    scale = float(np.asarray(host_vol)[0, 0, 0]
                  / (h[0][0] * h[1][0] * h[2][0]))
    A0, C1, C2 = (
        np.stack([-scale * h[d] * b
                  for b in _tridiagonal(host_dgst[d], mesh.N[d])], 0)
        for d in range(3)
    )
    return A0, C1, C2, h[0], h[1], h[2]


@dataclass(frozen=True)
class Poisson3DCoeffs:
    """Device copies of the ``poisson3d_coeffs`` arrays for one grid
    level, with the level's periodicity, in a coefficient dtype (float32
    or float64); checked once when built."""

    a0: torch.Tensor  # (3, N0)
    c1: torch.Tensor  # (3, N1)
    c2: torch.Tensor  # (3, N2)
    h0: torch.Tensor  # (N0,)
    h1: torch.Tensor  # (N1,)
    h2: torch.Tensor  # (N2,)
    periodic: tuple[bool, bool, bool]

    def __post_init__(self):
        for d, (band, h) in enumerate(((self.a0, self.h0), (self.c1, self.h1),
                                       (self.c2, self.h2))):
            if h.dim() != 1 or band.shape != (3, h.shape[0]):
                raise ValueError(f"poisson3d coefficients: axis {d} has "
                                 f"bands {tuple(band.shape)}, widths "
                                 f"{tuple(h.shape)}")
        _check_coeff_dtype("poisson3d coefficients", self.a0)
        _check_tensors("poisson3d coefficients", self.a0, {
            "a0": self.a0, "c1": self.c1, "c2": self.c2,
            "h0": self.h0, "h1": self.h1, "h2": self.h2})

    @classmethod
    def from_host(cls, arrays, periodic, dtype, device):
        return cls(*(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device) for a in arrays),
                   tuple(bool(x) for x in periodic))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.h0.shape[0], self.h1.shape[0], self.h2.shape[0])


def poisson3d_plain(mode, p, c: Poisson3DCoeffs, b=None, w=None,
                    omega=0.0):
    """Plain PyTorch version of the Poisson 3-D kernel (same function,
    same coefficient arrays): computed in the coefficients' dtype,
    returned in the fields'."""
    out_dtype = p.dtype
    p, b, w = _upcast(c.a0.dtype, p, b, w)
    return _poisson3d(mode, p, c, b, w, omega, _global_shift(p, c.periodic)).to(out_dtype)


def _poisson3d(mode, p, c, b, w, omega, sh):
    """The Poisson 3-D function with the neighbour reads of p from
    ``sh(axis, off)``: shared by the plain and the halo plain version."""
    def axis_sum(band, d):
        return sum(broadcast_1d(band[o + 1], 3, d) * (sh(d, o) if o else p)
                   for o in (-1, 0, 1))

    h0 = c.h0[:, None, None]
    h1 = c.h1[None, :, None]
    h2 = c.h2[None, None, :]
    sp = (h1 * h2 * axis_sum(c.a0, 0)
          + h0 * (h2 * axis_sum(c.c1, 1) + h1 * axis_sum(c.c2, 2)))
    return _poisson_mode(mode, sp, p, b, w, omega)


# The launch geometry of csrc/poisson3d.cu: blocks of 32 x 4 threads (one
# warp per row of the tile) that march over ``run`` planes, about
# n0 * tiles / POISSON3D_TARGET_BLOCKS and at most POISSON3D_RUNS[1]. On
# the H100 the smooth, the mode the V-cycle runs most, was fastest at rows
# 4 and 8 planes on the two finest levels of the 512x256x256 channel and,
# of rows 4, at 4 planes on the third (rows 4, 8, 16 and runs 1-64 swept
# by examples/plans512.py; PERF.md section 6); the levels whose tiles and
# planes number fewer than twice the target (about 8 blocks per SM of the
# 132) run one plane per block. Every block
# re-reads two planes of p (the ring's first two), so short runs cost
# bytes. The block stages axis 0's three band values and width per plane
# of its run in shared memory.
POISSON3D_TILE_ROWS = 4
POISSON3D_RUNS = (1, 8)
POISSON3D_TARGET_BLOCKS = 1024


@functools.lru_cache(maxsize=None)
def poisson3d_launch_plan(shape, dtype) -> MarchPlan:
    """The launch of the Poisson 3-D kernel on a block of ``shape`` cells
    (the grid, or one shard's block) with fields in ``dtype``: every cell
    computed by exactly one thread. Raises where the shape does not fit
    the CUDA grid."""
    item = coef_dtype(dtype).itemsize
    return _march_plan("poisson3d", shape, POISSON3D_TILE_ROWS, POISSON3D_RUNS,
                       POISSON3D_TARGET_BLOCKS, lambda run: 4 * item * run)


class Poisson3DKernel(_Kernel):
    """Wrapper of the Poisson 3-D kernel (csrc/poisson3d.cu)."""

    name = "poisson3d"
    argtypes = [_CI, ctypes.POINTER(_VP), *[_CI] * 6, ctypes.c_double,
                ctypes.POINTER(_CI), _VP]

    def __call__(self, mode, p, c: Poisson3DCoeffs, b=None, w=None,
                 omega=0.0):
        fields = _poisson_fields(self.name, mode, p, b, w, 3)
        if tuple(p.shape) != c.shape:
            raise ValueError(f"{self.name}: coefficients for {c.shape}, "
                             f"field {tuple(p.shape)}")
        # the coefficient arrays share a0's dtype and device (checked
        # when they were built)
        _check_tensors(self.name, p, fields, {"a0": c.a0})
        if _launch_target(self.name, p) == "cpu":
            return poisson3d_plain(mode, p, c, b, w, omega)
        plan = poisson3d_launch_plan(tuple(p.shape), p.dtype)
        out = torch.empty_like(p)
        ptrs = [t if t is None else t.data_ptr() for t in (
            p, b, w, c.a0, c.c1, c.c2, c.h0, c.h1, c.h2, out)]
        self._launch(p.dtype, (tuple(p.shape), c.periodic), POISSON_MODES[mode],
                     (_VP * 10)(*ptrs), *p.shape, *(int(x) for x in c.periodic),
                     float(omega), plan.as_c(), _stream_ptr(p))
        return out


poisson3d = Poisson3DKernel()


# ----------------------------------------------------------------------
# Momentum 3-D
# ----------------------------------------------------------------------
#
# Band row packing of build_momentum_bands_3d, shared by the three axes
# (pallas_stencil.py:790-806): Laplacian rows L(c, off) = c*5 + off+2
# (off -2..2), convection rows CV(var, lr, off) = 15 + var*6 + lr*3 +
# off+1 (var 0 tangential / 1 normal variant; lr 0 low / 1 high face).
# Laplacian rows carry -(mu dt / 2 rho), convection rows dt.

MOMENTUM3D_ROWS = 27


def mom3d_lap_row(c, off):
    return c * 5 + off + 2


def mom3d_conv_row(var, lr, off):
    return 15 + var * 6 + lr * 3 + off + 1


def build_momentum_bands_3d(mesh, axbcs, rho, mu, dt):
    """(B0, B1, B2): the packed numpy float64 band arrays (27, N_a),
    one per axis (counterpart of pallas_stencil.build_momentum_bands_3d,
    same rows)."""
    from fluca_tpu_torch.ns import tables as T_

    b = 0.5 * mu * dt / rho
    out = []
    for a in range(mesh.dim):
        B = np.zeros((MOMENTUM3D_ROWS, mesh.N[a]))
        for c in range(mesh.dim):
            st, _, _ = T_.lap_tables(mesh, a, axbcs[a], c)
            for off, w in st.as_dict().items():
                B[mom3d_lap_row(c, off)] = -b * np.asarray(w)
        for var in (0, 1):
            wl, wr = T_.conv_tables(mesh, a, axbcs[a], bool(var))
            for lr, wd in enumerate((wl, wr)):
                for off, w in wd.items():
                    B[mom3d_conv_row(var, lr, off)] = dt * np.asarray(w)
        out.append(B)
    return out


def _face_shape(shape, periodic, a):
    return tuple(n + (0 if periodic[a] else 1) if d == a else n
                 for d, n in enumerate(shape))


@dataclass(frozen=True)
class Momentum3DBands:
    """Device copies of the three band arrays, with the grid's
    periodicity, in a coefficient dtype (float32 or float64); checked
    once when built."""

    b: tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (27, N_a)
    periodic: tuple[bool, bool, bool]

    def __post_init__(self):
        if len(self.b) != 3 or any(
                B.dim() != 2 or B.shape[0] != MOMENTUM3D_ROWS for B in self.b):
            raise ValueError(f"momentum3d bands must be three "
                             f"({MOMENTUM3D_ROWS}, N_a) arrays")
        _check_coeff_dtype("momentum3d bands", self.b[0])
        _check_tensors("momentum3d bands", self.b[0],
                       {f"b{a}": B for a, B in enumerate(self.b)})

    @classmethod
    def from_host(cls, arrays, periodic, dtype, device):
        return cls(tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                         device=device) for a in arrays),
                   tuple(bool(x) for x in periodic))

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(B.shape[1] for B in self.b)


@dataclass(frozen=True)
class Momentum3DFactors:
    """The step's 12 face arrays as the kernel reads them: U0[a] and
    v0f[a][c] in face_shape(a) of the cell ``shape``, contiguous, on one
    device in one field dtype; checked once when built. ``from_faces``
    builds them once per step (the TPU ``prep``, here only a dtype and
    contiguity pass). The reduced-precision preconditioner builds its
    bf16 factors so, from the step's U0 and v0f, for bands in float32:
    the kernel reads the face arrays in place, so there is no tile
    layout that a cast of the float32 factors could get wrong."""

    U0: tuple
    v0f: tuple
    shape: tuple[int, int, int]  # the cell shape
    periodic: tuple[bool, bool, bool]
    # the face extent along each face array's own axis where it is not
    # the grid's (a rank's block owns n, or n + 1 faces at a wall's end)
    nfaces: tuple[int, int, int] | None = None

    def __post_init__(self):
        if len(self.U0) != 3 or len(self.v0f) != 3 \
                or any(len(r) != 3 for r in self.v0f):
            raise ValueError("momentum3d factors: U0 takes 3 face arrays, "
                             "v0f 3 x 3")
        faces = {f"U0[{a}]": (a, F) for a, F in enumerate(self.U0)}
        faces.update({f"v0f[{a}][{c}]": (a, F) for a, row in enumerate(self.v0f)
                      for c, F in enumerate(row)})
        for label, (a, F) in faces.items():
            want = _face_shape(self.shape, self.periodic, a)
            if self.nfaces is not None:
                want = tuple(self.nfaces[a] if d == a else m for d, m in enumerate(want))
            if not isinstance(F, torch.Tensor) or tuple(F.shape) != want:
                raise ValueError(f"momentum3d factors: {label} must have "
                                 f"shape {want}")
        _check_tensors("momentum3d factors", self.U0[0],
                       {label: F for label, (_, F) in faces.items()})

    @classmethod
    def from_faces(cls, U0, v0f, bands: Momentum3DBands, dtype=None, nfaces=None):
        """The factors in the field dtype ``dtype`` (the bands' dtype if
        None) for ``bands``, whose dtype must be its ``coef_dtype``;
        ``nfaces``: the face extents of a rank's block."""
        dtype = bands.b[0].dtype if dtype is None else dtype
        if dtype not in _DTYPE_SUFFIX or coef_dtype(dtype) != bands.b[0].dtype:
            raise TypeError(f"momentum3d factors: fields in {dtype} take "
                            f"bands in {coef_dtype(dtype)}, not "
                            f"{bands.b[0].dtype}")

        def prep(F):
            return F.to(dtype).contiguous() if isinstance(F, torch.Tensor) else F

        return cls(tuple(prep(F) for F in U0),
                   tuple(tuple(prep(F) for F in row) for row in v0f),
                   bands.shape, bands.periodic, None if nfaces is None else tuple(nfaces))


# The launch geometry of csrc/momentum3d.cu: a block of 32 x ``rows``
# threads owns a (rows x 32) tile of the (j, k) plane and marches along
# axis 0 over ``run`` planes, one cell per thread. ``run`` is about
# n0 * tiles / MOMENTUM3D_TARGET_BLOCKS, kept within MOMENTUM3D_RUNS and
# evened out over the planes: every block re-reads two planes of v (the
# ring's first two) and stages its band rows, so short runs cost bytes,
# and long ones leave too few blocks to hide the loads' latency (on the
# H100 16 planes were best at 128^3 and for a (2, 2, 2) shard of
# 512x256x256, 32 at 512x256x256). The block stages its band rows in
# shared memory, MOMENTUM3D_BAND_PITCH values per index (the 27 rows
# padded to whole 16-byte vectors), and one flag word per plane of its
# run.
MOMENTUM3D_TILE_ROWS = 4  # kTileRows of csrc/momentum3d.cu, which refuses another
MOMENTUM3D_BAND_PITCH = 28
MOMENTUM3D_RUNS = (16, 32)
MOMENTUM3D_TARGET_BLOCKS = 8192

@functools.lru_cache(maxsize=None)
def momentum3d_launch_plan(shape, dtype) -> MarchPlan:
    """The launch of the momentum 3-D kernel on a block of ``shape``
    cells (the grid, or one shard's block) with fields in ``dtype``:
    every cell computed by exactly one thread. Raises where the shape
    does not fit the CUDA grid or the shared memory."""
    rows = MOMENTUM3D_TILE_ROWS
    item = coef_dtype(dtype).itemsize
    return _march_plan(
        "momentum3d", shape, rows, MOMENTUM3D_RUNS, MOMENTUM3D_TARGET_BLOCKS,
        lambda run: item * MOMENTUM3D_BAND_PITCH * (run + rows + MARCH_LANES) + 4 * run)


def momentum3d_plain(bands: Momentum3DBands, f: Momentum3DFactors, v):
    """Plain PyTorch version of the momentum 3-D kernel: A v from the
    kernel's own inputs (the bands, the face factors and v), written
    from the algebra of the TPU kernel's body (pallas_stencil.py:
    1019-1129): the normal-variant sums on v_a shared by all
    components, the tangential-variant sums times the U0 factors for
    c != a, and the +-2 Laplacian rows on all three axes. Computed in
    the bands' dtype, returned in the fields'."""
    per = bands.periodic
    shape = v[0].shape
    out_dtype = v[0].dtype
    acc_dtype = bands.b[0].dtype
    v = _upcast(acc_dtype, *v)
    U0 = _upcast(acc_dtype, *f.U0)
    v0f = tuple(_upcast(acc_dtype, *row) for row in f.v0f)

    def lo_hi(a, F, _):
        if per[a]:
            return F, torch.roll(F, -1, a)
        n = shape[a]
        return F.narrow(a, 0, n), F.narrow(a, 1, n)

    shifts = [_global_shift(x, per) for x in v]
    out = _momentum3d(bands, U0, v0f, v, lambda e, a, off: shifts[e](a, off), lo_hi)
    return tuple(x.to(out_dtype) for x in out)


def _momentum3d(bands, U0, v0f, v, sh, lo_hi):
    """The momentum 3-D function with the neighbour reads of v[e] from
    ``sh(e, axis, off)`` and the (low, high) factors of face array F of
    axis a from ``lo_hi(a, F, (a, c))`` (c = None for U0[a]): shared by
    the plain and the halo plain version."""
    def band_sum(a, rows, e):
        return sum(broadcast_1d(bands.b[a][r], 3, a) * (sh(e, a, off) if off else v[e])
                   for off, r in rows)

    def conv_rows(var, lr):
        return [(off, mom3d_conv_row(var, lr, off)) for off in (-1, 0, 1)]

    acc = list(v)
    for a in range(3):
        FlU, FrU = lo_hi(a, U0[a], (a, None))
        nl = band_sum(a, conv_rows(1, 0), a)
        nr = band_sum(a, conv_rows(1, 1), a)
        for c in range(3):
            Flv, Frv = lo_hi(a, v0f[a][c], (a, c))
            s = band_sum(a, [(off, mom3d_lap_row(c, off))
                             for off in (-2, -1, 0, 1, 2)], c)
            if c == a:
                s = s + (Flv + FlU) * nl + (Frv + FrU) * nr
            else:
                s = (s + Flv * nl + Frv * nr
                     + FlU * band_sum(a, conv_rows(0, 0), c)
                     + FrU * band_sum(a, conv_rows(0, 1), c))
            acc[c] = acc[c] + s
    return acc


class Momentum3DKernel(_Kernel):
    """Wrapper of the momentum 3-D kernel (csrc/momentum3d.cu). The
    bands and the factors are checked when they are built; a call
    checks v and that the three agree: v in the factors' dtype, the
    bands in its ``coef_dtype``."""

    name = "momentum3d"
    argtypes = _PTRS_3D

    def __call__(self, bands: Momentum3DBands, f: Momentum3DFactors, v):
        if len(v) != 3:
            raise ValueError(f"{self.name}: v must hold 3 components")
        band0, ref = bands.b[0], f.U0[0]
        if f.shape != bands.shape or f.periodic != bands.periodic \
                or coef_dtype(ref.dtype) != band0.dtype \
                or ref.device != band0.device:
            raise ValueError(f"{self.name}: factors for {f.shape} "
                             f"periodic {f.periodic} {ref.dtype} on "
                             f"{ref.device}, bands for {bands.shape} "
                             f"periodic {bands.periodic} {band0.dtype} on "
                             f"{band0.device}")
        for e, x in enumerate(v):
            if not isinstance(x, torch.Tensor) or tuple(x.shape) != bands.shape:
                raise ValueError(f"{self.name}: v[{e}] must have shape "
                                 f"{bands.shape}")
        _check_tensors(self.name, ref, {f"v[{e}]": x for e, x in enumerate(v)})
        if _launch_target(self.name, ref) == "cpu":
            return momentum3d_plain(bands, f, v)
        plan = momentum3d_launch_plan(bands.shape, ref.dtype)
        out = tuple(torch.empty_like(x) for x in v)
        ptrs = (ctypes.c_void_p * 21)(*(t.data_ptr() for t in (
            *bands.b, *v, *f.U0, *(F for row in f.v0f for F in row), *out)))
        self._launch(ref.dtype, (bands.shape, bands.periodic), ptrs, *bands.shape,
                     *(int(x) for x in bands.periodic), plan.as_c(), _stream_ptr(ref))
        return out


momentum3d = Momentum3DKernel()


# ----------------------------------------------------------------------
# Halo instances: the kernels on the shards of a domain-decomposed grid
# ----------------------------------------------------------------------
#
# Counterparts of fluca_tpu/parallel/pallas_sharded.py, which runs the
# TPU kernels per shard under shard_map with edges from ppermute. A
# wrapper here takes the global tensors, the decomposition (HaloLayout)
# and the edge planes of each field (parallel/halo.py neighbor_slabs),
# launches one kernel per shard on that shard's box of the global
# tensors, and returns the global output. The float32 and float64
# instances only: the reference keeps the reduced-precision
# preconditioner off under a device grid (fluca_tpu/ns/cnlinear.py:
# 570-576).

# the AxisMode values of csrc/stencil_common.cuh
HALO_MODES = {"wall": 0, "periodic": 1, "halo": 2}
# local extents below this on a halo axis are refused by the momentum
# kernels: their +-2 Laplacian rows must not reach past an edge plane
MIN_MOMENTUM_LOCAL = 3


@dataclass(frozen=True)
class HaloLayout:
    """One call's decomposition: the device ``grid``
    (``parallel.mesh.DeviceGrid``: shard k owns the box k_a * n_a ..
    (k_a + 1) * n_a along each axis a) over a grid of ``shape`` cells with
    the ``periodic`` flags. An axis split over more than one shard is a
    halo axis: reads past a block come from edge planes. The others keep
    their global mode (wall or periodic)."""

    grid: DeviceGrid
    shape: tuple[int, ...]
    periodic: tuple[bool, ...]
    # a rank's block (``rank_block``): the axes split over ranks, which are
    # halo axes of the one block at offset 0; None for a DeviceGrid's shards
    split: tuple[bool, ...] | None = None

    def __post_init__(self):
        if len(self.periodic) != len(self.shape):
            raise ValueError(f"layout: shape {self.shape}, periodic {self.periodic}")
        self.grid.local_shape(self.shape)
        if self.split is not None and (len(self.split) != len(self.shape)
                                       or self.grid.size != 1):
            raise ValueError(f"layout: a rank's block takes a grid of one shard and a "
                             f"split flag per axis, not {self.grid.shape}, {self.split}")

    @classmethod
    def rank_block(cls, device, shape, periodic, split) -> "HaloLayout":
        """The layout of one rank's block of a ``parallel.mesh.RankGrid``:
        one block of ``shape`` cells at offset 0 on ``device``, whose axes
        split over ranks (``split``) are halo axes, with one edge plane per
        side of the block's extents. Its coefficient arrays are the
        block's rows (the geometry's global extents are the block's)."""
        D = len(shape)
        return cls(DeviceGrid((1,) * D, (torch.device(device),)), tuple(shape),
                   tuple(bool(p) for p in periodic), tuple(bool(x) for x in split))

    @functools.cached_property
    def local(self) -> tuple[int, ...]:
        """The extents of each shard's block."""
        return self.grid.local_shape(self.shape)

    @functools.cached_property
    def modes(self) -> tuple[str, ...]:
        """Per axis "halo", "periodic" or "wall" (HALO_MODES)."""
        split = self.split or tuple(s > 1 for s in self.grid.shape)
        return tuple("halo" if sp else "periodic" if per else "wall"
                     for sp, per in zip(split, self.periodic))

    @functools.cached_property
    def halo_axes(self) -> tuple[int, ...]:
        return tuple(a for a, m in enumerate(self.modes) if m == "halo")

    @property
    def key(self):
        """The (shape, band set) pair of the launch ledger: the global,
        local and grid shapes, and the axis modes with the global
        periodicity."""
        return (self.shape, self.local, self.grid.shape), (self.modes, self.periodic)

    def start(self, k) -> tuple[int, ...]:
        """The first index of shard ``k``'s box."""
        return tuple(c * n for c, n in zip(k, self.local))

    def edge_shape(self, a) -> tuple[int, ...]:
        """The shape of axis ``a``'s edge-plane stacks: one plane per
        shard along ``a``, the global extents along the others."""
        return tuple(s if d == a else n
                     for d, (n, s) in enumerate(zip(self.shape, self.grid.shape)))


def halo_shifted(x, a, off, edge, nshards, periodic):
    """y[i] = x[i + off] along axis ``a`` inside each shard's block of
    ``x`` (``nshards`` blocks along ``a``), with the edge planes ``edge`` =
    (lo, hi) at local index -1 and n and zeros further out; ``shifted``
    where ``a`` is not split (``edge`` None)."""
    if edge is None:
        return shifted(x, a, off, x.shape[a], periodic)
    if off == 0:
        return x
    lo, hi = edge
    n = x.shape[a] // nshards
    ext = torch.cat([lo.unsqueeze(a + 1), x.unflatten(a, (nshards, n)),
                     hi.unsqueeze(a + 1)], a + 1)
    return shifted(ext, a + 1, off + 1, n, False).flatten(a, a + 1)


def _halo_shift(x, layout, edges):
    """sh(axis, off): ``x`` shifted with ``halo_shifted``."""
    return lambda a, off: halo_shifted(x, a, off, edges[a], layout.grid.shape[a],
                                       layout.periodic[a])


def _check_halo_call(name, layout, ref, fields):
    """The layout fits the fields ``fields`` = {label: (tensor, edges)}:
    float32 or float64, the layout's shape, and per axis edge planes
    (lo, hi) of ``layout.edge_shape`` on the halo axes and None on the
    others, all with the strides of the first field's."""
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: no {ref.dtype} instance (float32 or float64)")
    est = None
    for label, (x, edges) in fields.items():
        if tuple(x.shape) != layout.shape:
            raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, the "
                             f"layout {layout.shape}")
        if len(edges) != len(layout.shape):
            raise ValueError(f"{name}: {label} needs edges for {len(layout.shape)} axes")
        for a, e in enumerate(edges):
            if a not in layout.halo_axes:
                if e is not None:
                    raise ValueError(f"{name}: {label} has edge planes on axis {a}, "
                                     f"which is not split")
                continue
            if e is None or len(e) != 2:
                raise ValueError(f"{name}: {label} needs (lo, hi) edge planes on "
                                 f"axis {a}")
            for side, t in zip(("lo", "hi"), e):
                if not isinstance(t, torch.Tensor) \
                        or tuple(t.shape) != layout.edge_shape(a) \
                        or t.dtype != ref.dtype or t.device != ref.device:
                    raise ValueError(f"{name}: {label} {side} edge of axis {a} must "
                                     f"be a {ref.dtype} tensor of shape "
                                     f"{layout.edge_shape(a)} on {ref.device}")
        strides = tuple(t.stride() for e in edges if e is not None for t in e)
        if est is None:
            est = strides
        elif strides != est:
            raise ValueError(f"{name}: {label}'s edge planes have other strides "
                             f"than the first field's")


def check_far_reads(name, layout, coefs):
    """A +-2 read that falls past an edge plane reads 0 in the halo
    kernels: its coefficient must be 0 there. ``coefs``: (grid axis a,
    offset -2 or 2, coefficient tensor, its axis that runs along a)."""
    for a, off, w, d in coefs:
        if a not in layout.halo_axes:
            continue
        n = layout.local[a]
        row = w.unflatten(d, (layout.grid.shape[a], n)).select(d + 1, 0 if off < 0 else n - 1)
        if bool(torch.any(row != 0)):
            raise ValueError(f"{name}: a {off:+d} read past the edge plane of axis "
                             f"{a} meets a nonzero coefficient (local extent {n})")


def check_momentum_local(name, layout):
    for a in layout.halo_axes:
        if layout.local[a] < MIN_MOMENTUM_LOCAL:
            raise ValueError(f"{name}: local extent {layout.local[a]} on halo axis "
                             f"{a} (at least {MIN_MOMENTUM_LOCAL}: the +-2 rows)")


def _ptr(t, index) -> int:
    """The address of element ``index`` of ``t``."""
    return t.data_ptr() + t.element_size() * sum(
        i * s for i, s in zip(index, t.stride()))


def _edge_strides(edges) -> tuple:
    """Each axis' edge-plane strides (None off the halo axes; lo and hi
    share theirs)."""
    return tuple(None if e is None else e[0].stride() for e in edges)


@functools.lru_cache(maxsize=None)
def _halo_launch(layout, strides, itemsize, edge_strides, extra=()):
    """The per-call constants of a halo call over ``layout`` for cell
    tensors of ``strides`` and ``itemsize`` bytes and edge-plane stacks of
    ``edge_strides`` (``_edge_strides``): the geometry array of
    csrc/stencil_common.cuh read_halo_geom (local and global extents, axis
    modes, the cell strides, each axis' edge-plane strides, then
    ``extra``); per shard, its box's first index, that index's byte offset
    in the cell tensors and per axis the byte offset of its edge planes
    (None off the halo axes); and whether the cell offsets and those of
    the axis-0 edge planes (which the 2-D kernels read 16 bytes at a time;
    they read the other axes' planes by the element) are multiples of 16
    bytes. Cached, so that a call adds one offset per tensor: the
    host's time per call bounds the sharded path where the kernels are
    fast. The kernels copy the geometry at launch."""
    D = len(layout.shape)
    est = [x for es in edge_strides for x in (es if es is not None else (0,) * D)]
    vals = [*layout.local, *layout.shape, *(HALO_MODES[m] for m in layout.modes),
            *strides, *est, *extra]
    shards = []
    for k in layout.grid.shards():
        start = layout.start(k)
        edges = tuple(None if es is None else itemsize * sum(
            (k[a] if d == a else i) * st for d, (i, st) in enumerate(zip(start, es)))
            for a, es in enumerate(edge_strides))
        shards.append((start, itemsize * sum(i * st for i, st in zip(start, strides)), edges))
    aligned = _aligned(x for _, cell, edges in shards for x in (cell, edges[0]))
    return (ctypes.c_longlong * len(vals))(*vals), tuple(shards), aligned


def _edge_bases(edges) -> list:
    """Each axis' (lo, hi) edge-plane addresses (None off the halo axes)."""
    return [None if e is None else (e[0].data_ptr(), e[1].data_ptr()) for e in edges]


def _edge_ptrs(bases, offsets) -> list:
    """A shard's lo and hi edge-plane addresses, axis by axis, from the
    stacks' ``_edge_bases`` and its ``_halo_launch`` byte offsets (None off
    the halo axes)."""
    out = []
    for base, off in zip(bases, offsets):
        out += (None, None) if base is None else (base[0] + off, base[1] + off)
    return out


def _rows_aligned(addresses, edges) -> bool:
    """A 2-D halo call's blocks and axis-0 edge rows (``addresses``) read
    16 bytes of cells at a time: every address aligned, and the edge rows
    contiguous along axis 1."""
    return _aligned(addresses) and (edges[0] is None or edges[0][0].stride(1) == 1)


def _col_ptr(t, start) -> int:
    """The address of column ``start`` of a 1-D or (rows, N) array."""
    return t.data_ptr() + start * t.element_size()


def poisson2d_halo_plain(mode, p, c: Poisson2DCoeffs, layout, edges, b=None, w=None,
                         omega=0.0):
    """Plain PyTorch version of the Poisson 2-D halo instance: every
    shard's block with its edge planes (``halo_shifted``), the same
    arithmetic as ``poisson2d_plain``."""
    return _poisson2d(mode, p, c, b, w, omega, _halo_shift(p, layout, edges))


def poisson3d_halo_plain(mode, p, c: Poisson3DCoeffs, layout, edges, b=None, w=None,
                         omega=0.0):
    """Plain PyTorch version of the Poisson 3-D halo instance."""
    return _poisson3d(mode, p, c, b, w, omega, _halo_shift(p, layout, edges))


@dataclass(frozen=True)
class PoissonHaloCall:
    """What a Poisson halo call needs of its mode, coefficients, layout
    and omega, checked against each other once
    (``_PoissonHaloKernel.prepare``): with each shard's coefficient
    addresses, at its first index."""

    mode: str
    c: object  # Poisson2DCoeffs or Poisson3DCoeffs
    layout: HaloLayout
    omega: float
    coeff_ptrs: tuple


class _PoissonHaloKernel(_Kernel):
    """Wrapper of a Poisson halo instance: (mode, p, coefficients,
    layout, p's edges[, b][, w][, omega]) -> the global Sp | b - Sp |
    smoothed p, one launch per shard. A caller that makes many calls on
    one level ``prepare``s them once and ``run``s each: the host's time
    per call bounds the sharded path where the kernels are fast."""

    instances = ("f32", "f64")

    def __init__(self, ndim, unsharded, plain):
        self.ndim = ndim
        self.name = f"{unsharded.name}_halo"
        self._unsharded = unsharded
        self._plain = plain
        self.argtypes = [_CI, _PP, _PL, ctypes.c_double, ctypes.POINTER(_CI), _VP]
        # p b w, the coefficient arrays, out, and the lo and hi edge planes
        # of each axis
        self._ptrs = _VP * (4 + (4 if ndim == 2 else 6) + 2 * ndim)
        super().__init__()

    @property
    def source(self) -> str:
        return self._unsharded.source

    def prepare(self, mode, c, layout: HaloLayout, omega=0.0) -> PoissonHaloCall:
        """The calls in ``mode`` on the coefficients ``c`` under ``layout``."""
        if mode not in POISSON_MODES:
            raise ValueError(f"{self.name}: unknown mode {mode!r}")
        if c.shape != layout.shape or c.periodic != layout.periodic:
            raise ValueError(f"{self.name}: coefficients for {c.shape} periodic "
                             f"{c.periodic}, layout {layout.shape} periodic "
                             f"{layout.periodic}")
        # the coefficient arrays in the C entry point's order, each with the
        # axis along which a shard's pointer moves to its first index
        arrays = (((c.rx, 0), (c.ry, 0), (c.cy, 1), (c.cyb, 1)) if self.ndim == 2 else
                  ((c.a0, 0), (c.c1, 1), (c.c2, 2), (c.h0, 0), (c.h1, 1), (c.h2, 2)))
        ptrs = tuple(tuple(_col_ptr(t, start[d]) for t, d in arrays)
                     for start in map(layout.start, layout.grid.shards()))
        return PoissonHaloCall(mode, c, layout, float(omega), ptrs)

    def __call__(self, mode, p, c, layout: HaloLayout, edges, b=None, w=None,
                 omega=0.0):
        return self.run(self.prepare(mode, c, layout, omega), p, edges, b, w)

    def run(self, call: PoissonHaloCall, p, edges, b=None, w=None):
        """The ``prepare``d call on p with its edge planes ``edges``."""
        c, layout = call.c, call.layout
        fields = _poisson_fields(self.name, call.mode, p, b, w, self.ndim)
        # the coefficient arrays share the first's dtype and device (checked
        # when they were built)
        _check_tensors(self.name, p, fields, {"coefficients": c.rx if self.ndim == 2 else c.a0})
        _check_halo_call(self.name, layout, p, {"p": (p, edges)})
        if _launch_target(self.name, p) == "cpu":
            return self._plain(call.mode, p, c, layout, edges, b, w, call.omega)
        out = torch.empty_like(p)
        geom, shards, offsets_aligned = _halo_launch(layout, p.stride(), p.element_size(),
                                                     _edge_strides(edges))
        cells = (p.data_ptr(), None if b is None else b.data_ptr(),
                 None if w is None else w.data_ptr(), out.data_ptr())
        ebases = _edge_bases(edges)
        if self.ndim == 3:
            plan = poisson3d_launch_plan(layout.local, p.dtype)
        else:
            # p, b, w, out and the edge rows of axis 0, read 16 bytes at a time
            plan = poisson2d_launch_plan(layout.local, p.dtype, offsets_aligned and _rows_aligned(
                (*cells, *(ebases[0] or ())), edges))
        plan, key, stream = plan.as_c(), layout.key, _stream_ptr(p)
        for (_, cell, eoffs), cptrs in zip(shards, call.coeff_ptrs):
            ptrs = self._ptrs(*(x if x is None else x + cell for x in cells[:3]), *cptrs,
                              cells[3] + cell, *_edge_ptrs(ebases, eoffs))
            self._launch(p.dtype, key, POISSON_MODES[call.mode], ptrs, geom, call.omega, plan,
                         stream)
        return out


poisson2d_halo = _PoissonHaloKernel(2, poisson2d, poisson2d_halo_plain)
poisson3d_halo = _PoissonHaloKernel(3, poisson3d, poisson3d_halo_plain)


def momentum2d_halo_plain(W, u, v, layout, u_edges, v_edges):
    """Plain PyTorch version of the momentum 2-D halo instance: every
    shard's block with its edge planes, the same arithmetic as
    ``momentum2d_plain``. Raises where a +-2 read past an edge plane
    would meet a nonzero plane entry."""
    check_far_reads("momentum2d_halo", layout, [
        (a, off, W[plane], a) for first in (18, 22)
        for plane, (a, off) in zip(range(first, first + 4),
                                   ((0, -2), (0, 2), (1, -2), (1, 2)))])
    return _momentum2d(W, u, v, _halo_shift(u, layout, u_edges),
                       _halo_shift(v, layout, v_edges))


class Momentum2DHaloKernel(_Kernel):
    """Wrapper of the momentum 2-D halo instance: (W, u, v, layout, u's
    edges, v's edges) -> the global (A u, A v), one launch per shard."""

    name = "momentum2d_halo"
    source = "momentum2d.cu"
    instances = ("f32", "f64")
    argtypes = [_PP, _PL, ctypes.POINTER(_CI), _VP]

    def __call__(self, W, u, v, layout: HaloLayout, u_edges, v_edges):
        if not isinstance(u, torch.Tensor) or u.dim() != 2 \
                or not isinstance(v, torch.Tensor) or v.shape != u.shape:
            raise ValueError(f"{self.name}: u and v must be 2-D tensors of one shape")
        if not isinstance(W, torch.Tensor) or \
                W.shape != (MOMENTUM_PLANES, *u.shape):
            raise ValueError(f"{self.name}: W must have shape "
                             f"{(MOMENTUM_PLANES, *u.shape)}")
        _check_tensors(self.name, u, {"W": W, "u": u, "v": v})
        _check_halo_call(self.name, layout, u, {"u": (u, u_edges), "v": (v, v_edges)})
        check_momentum_local(self.name, layout)
        if _launch_target(self.name, u) == "cpu":
            return momentum2d_halo_plain(W, u, v, layout, u_edges, v_edges)
        out = (torch.empty_like(u), torch.empty_like(v))
        geom, shards, offsets_aligned = _halo_launch(layout, u.stride(), u.element_size(),
                                                     _edge_strides(u_edges))
        # W's rows are u's, its block at u's offset
        cells = [t.data_ptr() for t in (W, u, v, *out)]
        ue, ve = _edge_bases(u_edges), _edge_bases(v_edges)
        plan = momentum2d_launch_plan(layout.local, u.dtype, offsets_aligned and _rows_aligned(
            (*cells, *(ue[0] or ()), *(ve[0] or ())), u_edges)).as_c()
        key, stream = layout.key, _stream_ptr(u)
        for _, cell, eoffs in shards:
            ptrs = (*(x + cell for x in cells), *_edge_ptrs(ue, eoffs), *_edge_ptrs(ve, eoffs))
            self._launch(u.dtype, key, (_VP * len(ptrs))(*ptrs), geom, plan, stream)
        return out


momentum2d_halo = Momentum2DHaloKernel()


def momentum3d_halo_plain(bands: Momentum3DBands, f: Momentum3DFactors, v, layout,
                          v_edges, face_hi):
    """Plain PyTorch version of the momentum 3-D halo instance: every
    shard's block with the edge planes of v and, on each halo axis,
    the hi face planes ``face_hi[a]`` (U0[a], v0f[a][0..2]) for the high
    factor of the block's last cell; the same arithmetic as
    ``momentum3d_plain``. Raises where a +-2 read past an edge plane
    would meet a nonzero band entry."""
    check_far_reads("momentum3d_halo", layout, [
        (a, off, bands.b[a][mom3d_lap_row(c, off)], 0)
        for a in range(3) for c in range(3) for off in (-2, 2)])
    shifts = [_halo_shift(x, layout, e) for x, e in zip(v, v_edges)]

    def lo_hi(a, F, which):
        N, per = layout.shape[a], layout.periodic[a]
        if a not in layout.halo_axes:
            return (F, torch.roll(F, -1, a)) if per else (F.narrow(a, 0, N),
                                                         F.narrow(a, 1, N))
        s, n = layout.grid.shape[a], layout.local[a]
        lo = F.narrow(a, 0, N)
        plane = face_hi[a][0 if which[1] is None else 1 + which[1]]
        hi = torch.cat([lo.unflatten(a, (s, n)).narrow(a + 1, 1, n - 1),
                        plane.unsqueeze(a + 1)], a + 1).flatten(a, a + 1)
        return lo, hi

    return tuple(_momentum3d(bands, f.U0, f.v0f, tuple(v),
                             lambda e, a, off: shifts[e](a, off), lo_hi))


class Momentum3DHaloKernel(_Kernel):
    """Wrapper of the momentum 3-D halo instance: (bands, factors, v,
    layout, v's edges by component, face_hi) -> the global A v, one
    launch per shard. ``face_hi[a]`` is None off the halo axes, else the
    hi face-plane stacks (``layout.edge_shape(a)``) of U0[a] and
    v0f[a][0..2]: face (k + 1) n_a of each, for shard k along a."""

    name = "momentum3d_halo"
    source = "momentum3d.cu"
    instances = ("f32", "f64")
    argtypes = [_PP, _PL, ctypes.POINTER(_CI), _VP]

    def __call__(self, bands: Momentum3DBands, f: Momentum3DFactors, v, layout,
                 v_edges, face_hi):
        if len(v) != 3 or len(v_edges) != 3:
            raise ValueError(f"{self.name}: v and v_edges must hold 3 components")
        band0, ref = bands.b[0], f.U0[0]
        if f.shape != bands.shape or f.periodic != bands.periodic \
                or ref.dtype != band0.dtype or ref.device != band0.device \
                or bands.shape != layout.shape or bands.periodic != layout.periodic:
            raise ValueError(f"{self.name}: factors for {f.shape} {ref.dtype}, bands "
                             f"for {bands.shape} periodic {bands.periodic} "
                             f"{band0.dtype}, layout {layout.shape} periodic "
                             f"{layout.periodic}")
        _check_tensors(self.name, ref, {f"v[{e}]": x for e, x in enumerate(v)})
        _check_halo_call(self.name, layout, ref, {f"v[{e}]": (x, ed) for e, (x, ed)
                                                  in enumerate(zip(v, v_edges))})
        check_momentum_local(self.name, layout)
        if len(face_hi) != 3:
            raise ValueError(f"{self.name}: face_hi needs an entry per axis")
        for a, planes in enumerate(face_hi):
            if a not in layout.halo_axes:
                if planes is not None:
                    raise ValueError(f"{self.name}: hi face planes on axis {a}, "
                                     f"which is not split")
                continue
            if planes is None or len(planes) != 4 or any(
                    not isinstance(t, torch.Tensor) or t.dtype != ref.dtype
                    or t.device != ref.device or tuple(t.shape) != layout.edge_shape(a)
                    or t.stride() != planes[0].stride() for t in planes):
                raise ValueError(f"{self.name}: face_hi[{a}] must be 4 {ref.dtype} "
                                 f"tensors of shape {layout.edge_shape(a)} with one "
                                 f"stride")
        if _launch_target(self.name, ref) == "cpu":
            return momentum3d_halo_plain(bands, f, v, layout, v_edges, face_hi)
        plan = momentum3d_launch_plan(layout.local, ref.dtype).as_c()
        out = tuple(torch.empty_like(x) for x in v)
        fst = [x for a in range(3) for x in f.U0[a].stride()]
        fest = [x for a in range(3)
                for x in (face_hi[a][0].stride() if face_hi[a] is not None else (0,) * 3)]
        geom, shards, _ = _halo_launch(layout, v[0].stride(), v[0].element_size(),
                                       _edge_strides(v_edges[0]), (*fst, *fest))
        ebases = [_edge_bases(e) for e in v_edges]
        faces = [*f.U0, *(F for row in f.v0f for F in row)]
        stream = _stream_ptr(ref)
        for k, (start, _, eoffs) in zip(layout.grid.shards(), shards):
            ptrs = [*(_col_ptr(B, start[a]) for a, B in enumerate(bands.b)),
                    *(_ptr(x, start) for x in (*v, *faces, *out)),
                    *(x for eb in ebases for x in _edge_ptrs(eb, eoffs)),
                    *self._face_hi_ptrs(layout, k, face_hi)]
            self._launch(ref.dtype, layout.key, (_VP * len(ptrs))(*ptrs), geom, plan,
                         stream)
        return out

    @staticmethod
    def _face_hi_ptrs(layout, k, face_hi):
        """Shard ``k``'s hi face-plane addresses: U0[0..2], then
        v0f[a][c] a-major (None off the halo axes)."""
        start = layout.start(k)

        def at(a, q):
            if face_hi[a] is None:
                return None
            return _ptr(face_hi[a][q], tuple(k[a] if d == a else i
                                             for d, i in enumerate(start)))

        return [at(a, 0) for a in range(3)] + [at(a, 1 + c) for a in range(3)
                                               for c in range(3)]


momentum3d_halo = Momentum3DHaloKernel()


# ----------------------------------------------------------------------
# The 3-D chain
# ----------------------------------------------------------------------

# Each stage's inputs and outputs, in the order of the C interface
# (csrc/chain3d.cu): (label, "cell" or "face", count); a group of 3 is a
# tuple by component or axis, a group of 1 a tensor.
CHAIN_STAGES = {
    "coupled": ((("Av", "cell", 3), ("v", "cell", 3), ("U", "face", 3),
                 ("p", "cell", 1)),
                (("v", "cell", 3), ("U", "face", 3), ("p", "cell", 1))),
    "pre": ((("v", "cell", 3), ("rU", "face", 3), ("rp", "cell", 1)),
            (("U", "face", 3), ("rp", "cell", 1))),
    "post": ((("vstar", "cell", 3), ("Ustar", "face", 3), ("p", "cell", 1)),
             (("v", "cell", 3), ("U", "face", 3))),
}


# The launch geometry of csrc/chain3d.cu: blocks of 32 x 4 threads over
# the face box nfaces(0) x nfaces(1) x nfaces(2), marching over ``run``
# planes: about n0 * tiles / CHAIN3D_TARGET_BLOCKS (4 blocks per SM of the
# H100's 132) within CHAIN3D_RUNS, evened out over the planes. On the
# H100 runs of 32 were the fastest or within 1.2 % of it for every stage
# at 512x256x256 and for coupled and pre at 128^3, of runs 16, 32 and 64
# (post at 128^3: 19 % faster at 16; examples/plans512.py, PERF.md
# section 6); the smaller grids take shorter runs to keep the blocks. The
# block stages its band rows in shared memory, CHAIN3D_BAND_PITCH values
# per index (the 24 rows padded so that the 16-byte reads of 8 lanes hit
# distinct banks), and one far-row mask per plane of its run.
CHAIN3D_TILE_ROWS = 4  # kTileRows of csrc/chain3d.cu, which refuses another
CHAIN3D_RUNS = (4, 32)
CHAIN3D_TARGET_BLOCKS = 512
CHAIN3D_BAND_PITCH = 28


def chain_face_box(shape, periodic) -> tuple[int, int, int]:
    """nfaces(a) per axis: N + 1 on a non-periodic axis, N on a periodic one."""
    return tuple(int(n) + (0 if per else 1) for n, per in zip(shape, periodic))


@functools.lru_cache(maxsize=None)
def chain3d_launch_plan(shape, periodic, dtype) -> MarchPlan:
    """The launch of a chain stage on a grid of ``shape`` cells with the
    ``periodic`` flags and fields in ``dtype``: every index of the face
    box computed by exactly one thread. Raises where the box does not
    fit the CUDA grid or the shared memory."""
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"chain3d: no launch for the shape {tuple(shape)}")
    box = chain_face_box(shape, periodic)
    if box[1] * box[2] >= 2**31:
        raise ValueError(f"chain3d: the shape {tuple(shape)} does not fit the card "
                         f"(a plane of {box[1] * box[2]} faces)")
    rows = CHAIN3D_TILE_ROWS
    item = torch.empty((), dtype=dtype).element_size()
    return _march_plan(
        "chain3d", box, rows, CHAIN3D_RUNS, CHAIN3D_TARGET_BLOCKS,
        lambda run: item * CHAIN3D_BAND_PITCH * (run + rows + MARCH_LANES) + 4 * run)


class Chain3DKernel(_Kernel):
    """Wrapper of one stage of the chain kernel (csrc/chain3d.cu) for a
    ``Chain3D`` (ops/chain3d.py): its bands, in the fields' dtype, its
    cell shape, periodicity and band fingerprint. Takes the stage's
    input groups (``CHAIN_STAGES``) and returns its output groups; the
    ledger keys its launches by (shape, instance, fingerprint)."""

    instances = ("f32", "f64")
    argtypes = _PTRS_3D
    source = "chain3d.cu"

    def __init__(self, stage):
        self.stage = stage
        self.name = f"chain3d_{stage}"
        super().__init__()

    def _shapes(self, chain, groups, spec):
        """Flatten ``groups`` by ``spec``, checking their count and the
        shape of every tensor; returns {label: tensor}."""
        if len(groups) != len(spec):
            raise ValueError(f"{self.name}: takes {len(spec)} groups "
                             f"({', '.join(s[0] for s in spec)}), got {len(groups)}")
        fields = {}
        for (label, kind, count), g in zip(spec, groups):
            ts = (g,) if count == 1 else tuple(g)
            if len(ts) != count:
                raise ValueError(f"{self.name}: {label} must hold {count} tensors")
            for e, t in enumerate(ts):
                want = chain.shape if kind == "cell" else _face_shape(
                    chain.shape, chain.periodic, e)
                name = label if count == 1 else f"{label}[{e}]"
                if not isinstance(t, torch.Tensor) or tuple(t.shape) != want:
                    raise ValueError(f"{self.name}: {name} must have shape {want}")
                fields[name] = t
        return fields

    def __call__(self, chain, *groups):
        ins, outs = CHAIN_STAGES[self.stage]
        fields = self._shapes(chain, groups, ins)
        ref = chain.b[0]
        _check_tensors(self.name, ref, {**fields, "b0": chain.b[0], "b1": chain.b[1],
                                        "b2": chain.b[2]})
        if _launch_target(self.name, ref) == "cpu":
            # imported here: ops/chain3d.py imports this module
            from fluca_tpu_torch.ops.chain3d import chain3d_plain

            return chain3d_plain(self.stage, chain.b, chain.periodic, *groups)
        if ref.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{self.name}: no {ref.dtype} instance (float32 or "
                            f"float64)")
        plan = chain3d_launch_plan(chain.shape, chain.periodic, ref.dtype)
        out = []
        for label, kind, count in outs:
            ts = tuple(torch.empty(chain.shape if kind == "cell" else _face_shape(
                chain.shape, chain.periodic, e), dtype=ref.dtype, device=ref.device)
                for e in range(count))
            out.append(ts[0] if count == 1 else ts)
        flat_out = [t for g in out for t in ((g,) if torch.is_tensor(g) else g)]
        tensors = (*chain.b, *fields.values(), *flat_out)
        ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
        self._launch(ref.dtype, (chain.shape, chain.fingerprint), ptrs, *chain.shape,
                     *(int(x) for x in chain.periodic), plan.as_c(), _stream_ptr(ref))
        return tuple(out)


chain3d_coupled = Chain3DKernel("coupled")
chain3d_pre = Chain3DKernel("pre")
chain3d_post = Chain3DKernel("post")

KERNELS = (poisson2d, momentum2d, poisson3d, momentum3d,
           chain3d_coupled, chain3d_pre, chain3d_post,
           poisson2d_halo, momentum2d_halo, poisson3d_halo, momentum3d_halo)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()


def launch_counts(kernels=KERNELS) -> dict:
    """The launches of ``kernels`` since their last reset, by instance:
    ``"<name>_<f32|f64|bf16>"``."""
    return {f"{k.name}_{sfx}": n for k in kernels for sfx, n in k.launches_by_dtype.items()}
