"""Hand-written CUDA kernels for the 2-D stencils of the NS step.

Counterpart of fluca_tpu.ops.pallas_stencil for the two kernels the
2-D time step runs:

- the fused pressure-Poisson stencil (``poisson2d_raw_call`` there) in
  its apply, residual and damped-Jacobi smooth modes, called on every
  multigrid level and by every Schur CG iteration;
- the fused momentum A-apply (``momentum2d_raw_call`` there), called by
  every momentum sweep and every coupled apply.

The CUDA sources live in ``fluca_tpu_torch/csrc``. They are compiled on
first use with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface, under ``build/fluca_tpu_torch/<source hash>/`` at the root
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

from fluca_tpu_torch.ops.banded import shifted

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("poisson2d.cu", "momentum2d.cu")
HEADERS = ("stencil_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libfluca_tpu_torch_kernels.so"

_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
POISSON_MODES = {"apply": 0, "residual": 1, "smooth": 2}
# The CUDA grid's y extent (one block row per 8 rows of the field).
_MAX_ROWS = 65535 * 8


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


def build_library() -> Path:
    """Compile the kernels unless a library built from the same sources
    exists; returns its path. The compiler's output goes to a
    temporary file first, so a cut build leaves nothing behind."""
    out_dir = build_dir() / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
           *[str(CSRC_DIR / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
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

    def bands_1d(st, n):
        out = st.as_dict()
        if not set(out) <= {-1, 0, 1}:
            raise ValueError(f"D@Gst is not tridiagonal: offsets {set(out)}")
        z = np.zeros(n)
        return out.get(-1, z), out.get(0, z), out.get(1, z)

    bx = bands_1d(host_dgst[0], N0)
    by = bands_1d(host_dgst[1], N1)
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
        if mode not in POISSON_MODES:
            raise ValueError(f"{self.name}: unknown mode {mode!r}")
        need = {"apply": (), "residual": ("b",), "smooth": ("b", "w")}[mode]
        given = {"b": b, "w": w}
        for k in ("b", "w"):
            if (k in need) != (given[k] is not None):
                raise ValueError(
                    f"{self.name}: mode {mode!r} takes "
                    f"{'p, ' + ', '.join(need) if need else 'p'}"
                )
        if not isinstance(p, torch.Tensor) or p.dim() != 2:
            raise ValueError(f"{self.name}: p must be a 2-D tensor")
        N0, N1 = p.shape
        if c.shape != (N0, N1) or c.rx.shape != (3, N0) \
                or c.cyb.shape != (3, N1):
            raise ValueError(f"{self.name}: coefficients for {c.shape}, "
                             f"field {tuple(p.shape)}")
        fields = {"p": p, "rx": c.rx, "ry": c.ry, "cy": c.cy, "cyb": c.cyb}
        for k in need:
            t = given[k]
            if not isinstance(t, torch.Tensor) or t.shape != p.shape:
                raise ValueError(f"{self.name}: {k} must have shape "
                                 f"{tuple(p.shape)}")
            fields[k] = t
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

KERNELS = (poisson2d, momentum2d)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
