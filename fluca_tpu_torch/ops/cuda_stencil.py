"""Hand-written CUDA kernels for the stencils of the NS step.

Counterpart of fluca_tpu.ops.pallas_stencil for the four kernels the
2-D and 3-D time steps run:

- the fused pressure-Poisson stencil in 2-D and 3-D
  (``poisson2d_raw_call`` and ``poisson3d_raw_call`` there) in its
  apply, residual and damped-Jacobi smooth modes, called on every
  multigrid level and by every Schur CG iteration;
- the fused momentum A-apply in 2-D and 3-D (``momentum2d_raw_call``
  and ``momentum3d_raw_calls`` there), called by every momentum sweep
  and every coupled apply.

The CUDA sources live in ``fluca_tpu_torch/csrc``. They are compiled on
first use with ``nvcc`` for ``sm_90a`` (one process per source, in
parallel) into a shared library with a plain C interface, under ``build/fluca_tpu_torch/<source hash>/`` at the root
of the checkout, and loaded with ctypes.

Each kernel has a plain PyTorch version of the same function beside
it, built from ``shifted`` on the same coefficient arrays. A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor
it launches the kernel or raises. Each wrapper counts its kernel
launches in ``launches``.
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

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("poisson2d.cu", "momentum2d.cu", "poisson3d.cu", "momentum3d.cu")
HEADERS = ("stencil_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libfluca_tpu_torch_kernels.so"

_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
POISSON_MODES = {"apply": 0, "residual": 1, "smooth": 2}
# The CUDA grid's y extent (one block row per 8 rows of the field).
_MAX_ROWS = 65535 * 8
# The CUDA grid's z extent (one block per plane of a 3-D field).
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
    """Build (if needed) and load the kernel library, once per
    process."""
    lib = ctypes.CDLL(str(build_library()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for sfx in _DTYPE_SUFFIX.values():
        fn = getattr(lib, f"fluca_poisson2d_{sfx}")
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ctypes.c_double, vp]
        fn.restype = ci
        fn = getattr(lib, f"fluca_momentum2d_{sfx}")
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
        fn = getattr(lib, f"fluca_poisson3d_{sfx}")
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, ci, ctypes.c_double, vp]
        fn.restype = ci
        fn = getattr(lib, f"fluca_momentum3d_{sfx}")
        fn.argtypes = [ctypes.POINTER(vp), ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _check_cuda(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ----------------------------------------------------------------------
# argument checks shared by the wrappers
# ----------------------------------------------------------------------

def _check_tensors(name, ref, tensors):
    """Every tensor on ``ref``'s device, in its dtype, contiguous."""
    if ref.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported "
                        f"(float32 or float64)")
    for label, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {label} is not a tensor")
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} on {t.device}, "
                             f"expected {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, "
                            f"expected {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")


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
    level, with the level's periodicity."""

    rx: torch.Tensor  # (3, N0)
    ry: torch.Tensor  # (N0,)
    cy: torch.Tensor  # (N1,)
    cyb: torch.Tensor  # (3, N1)
    periodic: tuple[bool, bool]

    @classmethod
    def from_host(cls, arrays, periodic, dtype, device):
        rx, ry, cy, cyb = (
            torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
            for a in arrays
        )
        return cls(rx, ry, cy, cyb, (bool(periodic[0]), bool(periodic[1])))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ry.shape[0], self.cy.shape[0])


def poisson2d_plain(mode, p, c: Poisson2DCoeffs, b=None, w=None,
                    omega=0.0):
    """Plain PyTorch version of the Poisson 2-D kernel (same function,
    same coefficient arrays)."""
    N0, N1 = p.shape
    per0, per1 = c.periodic
    x = (
        c.rx[0][:, None] * shifted(p, 0, -1, N0, per0)
        + c.rx[1][:, None] * p
        + c.rx[2][:, None] * shifted(p, 0, 1, N0, per0)
    ) * c.cy[None, :]
    y = c.ry[:, None] * (
        c.cyb[0][None, :] * shifted(p, 1, -1, N1, per1)
        + c.cyb[1][None, :] * p
        + c.cyb[2][None, :] * shifted(p, 1, 1, N1, per1)
    )
    sp = x + y
    if mode == "apply":
        return sp
    if mode == "residual":
        return b - sp
    return p + omega * w * (b - sp)


class Poisson2DKernel:
    """Wrapper of the Poisson 2-D kernel (csrc/poisson2d.cu)."""

    name = "poisson2d"

    def __init__(self):
        self.launches = 0

    def __call__(self, mode, p, c: Poisson2DCoeffs, b=None, w=None,
                 omega=0.0):
        fields = _poisson_fields(self.name, mode, p, b, w, 2)
        N0, N1 = p.shape
        if c.shape != (N0, N1) or c.rx.shape != (3, N0) \
                or c.cyb.shape != (3, N1):
            raise ValueError(f"{self.name}: coefficients for {c.shape}, "
                             f"field {tuple(p.shape)}")
        fields.update(rx=c.rx, ry=c.ry, cy=c.cy, cyb=c.cyb)
        _check_tensors(self.name, p, fields)
        if _launch_target(self.name, p) == "cpu":
            return poisson2d_plain(mode, p, c, b, w, omega)
        if N0 == 0 or N1 == 0 or N0 > _MAX_ROWS:
            raise ValueError(f"{self.name}: unsupported shape {(N0, N1)}")
        out = torch.empty_like(p)
        fn = getattr(load_library(), f"fluca_poisson2d_{_DTYPE_SUFFIX[p.dtype]}")
        err = fn(
            POISSON_MODES[mode], p.data_ptr(),
            b.data_ptr() if b is not None else None,
            w.data_ptr() if w is not None else None,
            c.rx.data_ptr(), c.ry.data_ptr(), c.cy.data_ptr(),
            c.cyb.data_ptr(), out.data_ptr(), N0, N1,
            int(c.periodic[0]), int(c.periodic[1]), float(omega),
            _stream_ptr(p),
        )
        _check_cuda(self.name, err)
        self.launches += 1
        return out


poisson2d = Poisson2DKernel()


# ----------------------------------------------------------------------
# Momentum 2-D
# ----------------------------------------------------------------------

MOMENTUM_PLANES = 26


def momentum2d_plain(W, u, v, periodic):
    """Plain PyTorch version of the momentum 2-D kernel: A (u, v) from
    the (26, N0, N1) plane stack of
    NSOperators.build_momentum_coeffs_stacked."""
    N0, N1 = u.shape
    per0, per1 = periodic

    def sx(x, o):
        return shifted(x, 0, o, N0, per0)

    def sy(x, o):
        return shifted(x, 1, o, N1, per1)

    out_u = (
        W[0] * sx(u, -1) + W[1] * u + W[2] * sx(u, 1)
        + W[3] * sy(u, -1) + W[4] * u + W[5] * sy(u, 1)
        + W[6] * sy(v, -1) + W[7] * v + W[8] * sy(v, 1)
        + W[18] * sx(u, -2) + W[19] * sx(u, 2)
        + W[20] * sy(u, -2) + W[21] * sy(u, 2)
    )
    out_v = (
        W[9] * sx(v, -1) + W[10] * v + W[11] * sx(v, 1)
        + W[12] * sy(v, -1) + W[13] * v + W[14] * sy(v, 1)
        + W[15] * sx(u, -1) + W[16] * u + W[17] * sx(u, 1)
        + W[22] * sx(v, -2) + W[23] * sx(v, 2)
        + W[24] * sy(v, -2) + W[25] * sy(v, 2)
    )
    return out_u, out_v


class Momentum2DKernel:
    """Wrapper of the momentum 2-D kernel (csrc/momentum2d.cu)."""

    name = "momentum2d"

    def __init__(self):
        self.launches = 0

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
        if N0 == 0 or N1 == 0 or N0 > _MAX_ROWS:
            raise ValueError(f"{self.name}: unsupported shape {(N0, N1)}")
        out_u = torch.empty_like(u)
        out_v = torch.empty_like(v)
        fn = getattr(load_library(), f"fluca_momentum2d_{_DTYPE_SUFFIX[u.dtype]}")
        err = fn(W.data_ptr(), u.data_ptr(), v.data_ptr(),
                 out_u.data_ptr(), out_v.data_ptr(), N0, N1,
                 int(per0), int(per1), _stream_ptr(u))
        _check_cuda(self.name, err)
        self.launches += 1
        return out_u, out_v


momentum2d = Momentum2DKernel()


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
    level, with the level's periodicity; checked once when built."""

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
    same coefficient arrays)."""

    def axis_sum(band, d):
        shape = [1, 1, 1]
        shape[d] = -1
        n = p.shape[d]
        return sum(band[o + 1].reshape(shape)
                   * shifted(p, d, o, n, c.periodic[d]) for o in (-1, 0, 1))

    h0 = c.h0[:, None, None]
    h1 = c.h1[None, :, None]
    h2 = c.h2[None, None, :]
    sp = (h1 * h2 * axis_sum(c.a0, 0)
          + h0 * (h2 * axis_sum(c.c1, 1) + h1 * axis_sum(c.c2, 2)))
    if mode == "apply":
        return sp
    if mode == "residual":
        return b - sp
    return p + omega * w * (b - sp)


class Poisson3DKernel:
    """Wrapper of the Poisson 3-D kernel (csrc/poisson3d.cu)."""

    name = "poisson3d"

    def __init__(self):
        self.launches = 0

    def __call__(self, mode, p, c: Poisson3DCoeffs, b=None, w=None,
                 omega=0.0):
        fields = _poisson_fields(self.name, mode, p, b, w, 3)
        if tuple(p.shape) != c.shape:
            raise ValueError(f"{self.name}: coefficients for {c.shape}, "
                             f"field {tuple(p.shape)}")
        fields["a0"] = c.a0  # the coefficients' dtype and device
        _check_tensors(self.name, p, fields)
        if _launch_target(self.name, p) == "cpu":
            return poisson3d_plain(mode, p, c, b, w, omega)
        N0, N1, N2 = p.shape
        if 0 in (N0, N1, N2) or N0 > _MAX_PLANES or N1 > _MAX_ROWS:
            raise ValueError(f"{self.name}: unsupported shape {(N0, N1, N2)}")
        out = torch.empty_like(p)
        fn = getattr(load_library(), f"fluca_poisson3d_{_DTYPE_SUFFIX[p.dtype]}")
        err = fn(
            POISSON_MODES[mode], p.data_ptr(),
            b.data_ptr() if b is not None else None,
            w.data_ptr() if w is not None else None,
            c.a0.data_ptr(), c.c1.data_ptr(), c.c2.data_ptr(),
            c.h0.data_ptr(), c.h1.data_ptr(), c.h2.data_ptr(),
            out.data_ptr(), N0, N1, N2, *(int(x) for x in c.periodic),
            float(omega), _stream_ptr(p),
        )
        _check_cuda(self.name, err)
        self.launches += 1
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
    periodicity; checked once when built."""

    b: tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (27, N_a)
    periodic: tuple[bool, bool, bool]

    def __post_init__(self):
        if len(self.b) != 3 or any(
                B.dim() != 2 or B.shape[0] != MOMENTUM3D_ROWS for B in self.b):
            raise ValueError(f"momentum3d bands must be three "
                             f"({MOMENTUM3D_ROWS}, N_a) arrays")
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
    device in one dtype; checked once when built. ``from_faces`` builds
    them once per step (the TPU ``prep``, here only a dtype and
    contiguity pass)."""

    U0: tuple
    v0f: tuple
    shape: tuple[int, int, int]  # the cell shape
    periodic: tuple[bool, bool, bool]

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
            if not isinstance(F, torch.Tensor) or tuple(F.shape) != want:
                raise ValueError(f"momentum3d factors: {label} must have "
                                 f"shape {want}")
        _check_tensors("momentum3d factors", self.U0[0],
                       {label: F for label, (_, F) in faces.items()})

    @classmethod
    def from_faces(cls, U0, v0f, bands: Momentum3DBands):
        dtype = bands.b[0].dtype

        def prep(F):
            return F.to(dtype).contiguous() if isinstance(F, torch.Tensor) else F

        return cls(tuple(prep(F) for F in U0),
                   tuple(tuple(prep(F) for F in row) for row in v0f),
                   bands.shape, bands.periodic)


def momentum3d_plain(bands: Momentum3DBands, f: Momentum3DFactors, v):
    """Plain PyTorch version of the momentum 3-D kernel: A v from the
    kernel's own inputs (the bands, the face factors and v), written
    from the algebra of the TPU kernel's body (pallas_stencil.py:
    1019-1129): the normal-variant sums on v_a shared by all
    components, the tangential-variant sums times the U0 factors for
    c != a, and the +-2 Laplacian rows on all three axes."""
    per = bands.periodic
    shape = v[0].shape

    def sh(x, a, off):
        return shifted(x, a, off, shape[a], per[a])

    def lo_hi(F, a):
        if per[a]:
            return F, torch.roll(F, -1, a)
        n = shape[a]
        return F.narrow(a, 0, n), F.narrow(a, 1, n)

    def band_sum(a, rows, x):
        return sum(broadcast_1d(bands.b[a][r], 3, a) * sh(x, a, off)
                   for off, r in rows)

    def conv_rows(var, lr):
        return [(off, mom3d_conv_row(var, lr, off)) for off in (-1, 0, 1)]

    acc = list(v)
    for a in range(3):
        FlU, FrU = lo_hi(f.U0[a], a)
        nl = band_sum(a, conv_rows(1, 0), v[a])
        nr = band_sum(a, conv_rows(1, 1), v[a])
        for c in range(3):
            Flv, Frv = lo_hi(f.v0f[a][c], a)
            s = band_sum(a, [(off, mom3d_lap_row(c, off))
                             for off in (-2, -1, 0, 1, 2)], v[c])
            if c == a:
                s = s + (Flv + FlU) * nl + (Frv + FrU) * nr
            else:
                s = (s + Flv * nl + Frv * nr
                     + FlU * band_sum(a, conv_rows(0, 0), v[c])
                     + FrU * band_sum(a, conv_rows(0, 1), v[c]))
            acc[c] = acc[c] + s
    return tuple(acc)


class Momentum3DKernel:
    """Wrapper of the momentum 3-D kernel (csrc/momentum3d.cu). The
    bands and the factors are checked when they are built; a call
    checks v and that the three agree."""

    name = "momentum3d"

    def __init__(self):
        self.launches = 0

    def __call__(self, bands: Momentum3DBands, f: Momentum3DFactors, v):
        if len(v) != 3:
            raise ValueError(f"{self.name}: v must hold 3 components")
        ref = bands.b[0]
        if f.shape != bands.shape or f.periodic != bands.periodic \
                or f.U0[0].dtype != ref.dtype or f.U0[0].device != ref.device:
            raise ValueError(f"{self.name}: factors for {f.shape} "
                             f"periodic {f.periodic} {f.U0[0].dtype} on "
                             f"{f.U0[0].device}, bands for {bands.shape} "
                             f"periodic {bands.periodic} {ref.dtype} on "
                             f"{ref.device}")
        for e, x in enumerate(v):
            if not isinstance(x, torch.Tensor) or tuple(x.shape) != bands.shape:
                raise ValueError(f"{self.name}: v[{e}] must have shape "
                                 f"{bands.shape}")
        _check_tensors(self.name, ref, {f"v[{e}]": x for e, x in enumerate(v)})
        if _launch_target(self.name, ref) == "cpu":
            return momentum3d_plain(bands, f, v)
        N0, N1, N2 = bands.shape
        if 0 in (N0, N1, N2) or N0 > _MAX_PLANES or N1 > _MAX_ROWS:
            raise ValueError(f"{self.name}: unsupported shape {(N0, N1, N2)}")
        out = tuple(torch.empty_like(x) for x in v)
        ptrs = (ctypes.c_void_p * 21)(*(t.data_ptr() for t in (
            *bands.b, *v, *f.U0, *(F for row in f.v0f for F in row), *out)))
        fn = getattr(load_library(),
                     f"fluca_momentum3d_{_DTYPE_SUFFIX[ref.dtype]}")
        err = fn(ptrs, N0, N1, N2, *(int(x) for x in bands.periodic),
                 _stream_ptr(ref))
        _check_cuda(self.name, err)
        self.launches += 1
        return out


momentum3d = Momentum3DKernel()

KERNELS = (poisson2d, momentum2d, poisson3d, momentum3d)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
