// Fused 2-D pressure-Poisson stencil: apply, residual and damped-Jacobi
// smooth.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// poisson2d_raw_call (wrapped by _build_poisson_2d and
// build_poisson_{apply,residual,smooth}_2d). It computes
//
//   Sp[i,j] = CY[j] * sum_o RX[o,i] * p[i+o,j]
//           + RY[i] * sum_o CYb[o,j] * p[i,j+o]          (o in -1,0,1)
//
// and, by MODE, writes  Sp  |  b - Sp  |  p + omega * w * (b - Sp).
// Neighbours outside a non-periodic axis read 0 and wrap on a periodic
// one (fluca_tpu_torch.ops.banded.shifted), so no halo rows or columns
// are passed in. RX is (3,N0), RY (N0), CY (N1), CYb (3,N1), in the type
// the instance computes in; p, b, w and out are (N0,N1), C-contiguous,
// in the field type. Instances: f32 and f64 (fields, coefficients and
// arithmetic in one type), and bf16 (bf16 p, b, w and out; float
// coefficients and arithmetic; one rounding, at the store), the
// counterpart of the TPU kernel's bf16 instance under precond_dtype.
//
// What bounds it on an H100: memory traffic. Per cell it does about 13
// (apply) to 16 (smooth) flops against 8, 12 or 16 bytes of f32 field
// traffic (half that in bf16), far below the card's flop:byte ratio.
// At the cavity's own sizes (256^2 and its coarser multigrid levels)
// one f32 field is at most 256 KB and the whole working set sits in the 50 MB L2, so a
// launch is bound by launch latency rather than by bandwidth.
//
// What the design does about it: one thread per cell reads each field
// once from device memory (the four neighbour reads of p hit L1/L2),
// warps run along the contiguous axis for coalesced loads, and the
// three modes are template instances so the residual and the smoother
// are one pass each instead of an apply plus an elementwise pass.
// Shared-memory tiling and batching several launches into one are
// later work.
#include "stencil_common.cuh"

namespace {

template <typename T, int MODE>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
poisson2d_kernel(const T* __restrict__ p, const T* __restrict__ b,
                 const T* __restrict__ w,
                 const fluca::acc_t<T>* __restrict__ rx,
                 const fluca::acc_t<T>* __restrict__ ry,
                 const fluca::acc_t<T>* __restrict__ cy,
                 const fluca::acc_t<T>* __restrict__ cyb, T* __restrict__ out,
                 int N0, int N1, int per0, int per1, fluca::acc_t<T> omega) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= N0 || j >= N1) return;
    const size_t idx = (size_t)i * N1 + j;

    const C pc = F::load(p + idx);
    const C up = fluca::load2d(p, i - 1, j, N0, N1, per0, per1);
    const C dn = fluca::load2d(p, i + 1, j, N0, N1, per0, per1);
    const C lf = fluca::load2d(p, i, j - 1, N0, N1, per0, per1);
    const C rt = fluca::load2d(p, i, j + 1, N0, N1, per0, per1);

    const C xterm = (__ldg(rx + i) * up + __ldg(rx + N0 + i) * pc +
                     __ldg(rx + 2 * N0 + i) * dn) *
                    __ldg(cy + j);
    const C yterm = __ldg(ry + i) *
                    (__ldg(cyb + j) * lf + __ldg(cyb + N1 + j) * pc +
                     __ldg(cyb + 2 * N1 + j) * rt);
    const C sp = xterm + yterm;

    if (MODE == 0) {
        F::store(out + idx, sp);
    } else if (MODE == 1) {
        F::store(out + idx, F::load(b + idx) - sp);
    } else {
        F::store(out + idx,
                 pc + omega * F::load(w + idx) * (F::load(b + idx) - sp));
    }
}

template <typename T>
int launch(int mode, const void* p, const void* b, const void* w,
           const void* rx, const void* ry, const void* cy, const void* cyb,
           void* out, int N0, int N1, int per0, int per1, double omega,
           void* stream) {
    using C = fluca::acc_t<T>;
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid2d(N0, N1);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* P = static_cast<const T*>(p);
    const T* B = static_cast<const T*>(b);
    const T* W = static_cast<const T*>(w);
    const C* RX = static_cast<const C*>(rx);
    const C* RY = static_cast<const C*>(ry);
    const C* CY = static_cast<const C*>(cy);
    const C* CYB = static_cast<const C*>(cyb);
    T* O = static_cast<T*>(out);
    const C om = static_cast<C>(omega);
    switch (mode) {
        case 0:
            poisson2d_kernel<T, 0><<<grid, block, 0, s>>>(
                P, B, W, RX, RY, CY, CYB, O, N0, N1, per0, per1, om);
            break;
        case 1:
            poisson2d_kernel<T, 1><<<grid, block, 0, s>>>(
                P, B, W, RX, RY, CY, CYB, O, N0, N1, per0, per1, om);
            break;
        case 2:
            poisson2d_kernel<T, 2><<<grid, block, 0, s>>>(
                P, B, W, RX, RY, CY, CYB, O, N0, N1, per0, per1, om);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define FLUCA_POISSON2D_EXPORT(SFX, T)                                      \
    extern "C" int fluca_poisson2d_##SFX(                                   \
        int mode, const void* p, const void* b, const void* w,              \
        const void* rx, const void* ry, const void* cy, const void* cyb,    \
        void* out, int N0, int N1, int per0, int per1, double omega,        \
        void* stream) {                                                     \
        return launch<T>(mode, p, b, w, rx, ry, cy, cyb, out, N0, N1, per0, \
                         per1, omega, stream);                              \
    }

FLUCA_POISSON2D_EXPORT(f32, float)
FLUCA_POISSON2D_EXPORT(f64, double)
FLUCA_POISSON2D_EXPORT(bf16, __nv_bfloat16)

// ---------------------------------------------------------------------
// Halo instance (f32, f64): one shard's block, for the domain-decomposed
// step. Replaces the TPU kernel fluca_tpu/parallel/pallas_sharded.py
// build_poisson_sharded (2-D), which runs poisson2d_raw_call per shard
// with edge rows and columns from ppermute. Same arithmetic as the
// kernel above, in the same order, so a block matches the unsharded
// kernel bit for bit; only the source of the neighbour reads differs
// (stencil_common.cuh halo_load). The coefficient arrays are per global
// index: each pointer is at the block's first index, rows ng apart.
// Bound and design as above: the block and its edge rows and columns
// are read once.
namespace {

template <typename T, int MODE>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
poisson2d_halo_kernel(const fluca::HaloField<T, 2> p, const T* __restrict__ b,
                      const T* __restrict__ w, const T* __restrict__ rx,
                      const T* __restrict__ ry, const T* __restrict__ cy,
                      const T* __restrict__ cyb, T* __restrict__ out,
                      const fluca::HaloGeom<2> g, T omega) {
    using F = fluca::Field<T>;
    using C = T;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= g.n[0] || j >= g.n[1]) return;
    const int pos[2] = {i, j};
    const long long idx = fluca::halo_offset(g, pos);
    const int N0 = g.ng[0], N1 = g.ng[1];

    const C pc = F::load(p.x + idx);
    const C up = fluca::halo_load(p, g, pos, 0, -1);
    const C dn = fluca::halo_load(p, g, pos, 0, 1);
    const C lf = fluca::halo_load(p, g, pos, 1, -1);
    const C rt = fluca::halo_load(p, g, pos, 1, 1);

    const C xterm = (__ldg(rx + i) * up + __ldg(rx + N0 + i) * pc +
                     __ldg(rx + 2 * N0 + i) * dn) *
                    __ldg(cy + j);
    const C yterm = __ldg(ry + i) *
                    (__ldg(cyb + j) * lf + __ldg(cyb + N1 + j) * pc +
                     __ldg(cyb + 2 * N1 + j) * rt);
    const C sp = xterm + yterm;

    if (MODE == 0) {
        F::store(out + idx, sp);
    } else if (MODE == 1) {
        F::store(out + idx, F::load(b + idx) - sp);
    } else {
        F::store(out + idx,
                 pc + omega * F::load(w + idx) * (F::load(b + idx) - sp));
    }
}

// ptrs: p b w rx ry cy cyb out | p's edge planes lo0 hi0 lo1 hi1 (null
// on an axis that is not a halo axis); geom: read_halo_geom<2>.
template <typename T>
int launch_halo(int mode, const void* const* ptrs, const long long* geom,
                double omega, void* stream) {
    fluca::HaloGeom<2> g;
    fluca::read_halo_geom(geom, g);
    fluca::HaloField<T, 2> p;
    p.x = static_cast<const T*>(ptrs[0]);
    for (int a = 0; a < 2; ++a) {
        p.lo[a] = static_cast<const T*>(ptrs[8 + 2 * a]);
        p.hi[a] = static_cast<const T*>(ptrs[9 + 2 * a]);
    }
    const T* B = static_cast<const T*>(ptrs[1]);
    const T* W = static_cast<const T*>(ptrs[2]);
    const T* RX = static_cast<const T*>(ptrs[3]);
    const T* RY = static_cast<const T*>(ptrs[4]);
    const T* CY = static_cast<const T*>(ptrs[5]);
    const T* CYB = static_cast<const T*>(ptrs[6]);
    T* O = static_cast<T*>(const_cast<void*>(ptrs[7]));
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid2d(g.n[0], g.n[1]);
    if (grid.y > fluca::kMaxGridYZ) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T om = static_cast<T>(omega);
    switch (mode) {
        case 0:
            poisson2d_halo_kernel<T, 0><<<grid, block, 0, s>>>(
                p, B, W, RX, RY, CY, CYB, O, g, om);
            break;
        case 1:
            poisson2d_halo_kernel<T, 1><<<grid, block, 0, s>>>(
                p, B, W, RX, RY, CY, CYB, O, g, om);
            break;
        case 2:
            poisson2d_halo_kernel<T, 2><<<grid, block, 0, s>>>(
                p, B, W, RX, RY, CY, CYB, O, g, om);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define FLUCA_POISSON2D_HALO_EXPORT(SFX, T)                                 \
    extern "C" int fluca_poisson2d_halo_##SFX(                              \
        int mode, const void* const* ptrs, const long long* geom,           \
        double omega, void* stream) {                                       \
        return launch_halo<T>(mode, ptrs, geom, omega, stream);             \
    }

FLUCA_POISSON2D_HALO_EXPORT(f32, float)
FLUCA_POISSON2D_HALO_EXPORT(f64, double)
