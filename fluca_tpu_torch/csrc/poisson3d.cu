// Fused 3-D pressure-Poisson stencil (7-point): apply, residual and
// damped-Jacobi smooth.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// poisson3d_raw_call (wrapped by _build_poisson_3d and
// build_poisson_{apply,residual,smooth}_3d). It computes
//
//   Sp[i,j,k] = H1[j] H2[k] * sum_o A0[o,i] p[i+o,j,k]
//             + H0[i] * ( H2[k] * sum_o C1[o,j] p[i,j+o,k]
//                       + H1[j] * sum_o C2[o,k] p[i,j,k+o] )   (o in -1,0,1)
//
// (the separable form of vol .* (-D Gst) p; H* are the cell widths and
// A0, C1, C2 the scaled 1-D D@Gst bands, see
// fluca_tpu_torch.ops.cuda_stencil.poisson3d_coeffs) and, by MODE,
// writes  Sp  |  b - Sp  |  p + omega * w * (b - Sp).
// Neighbours outside a non-periodic axis read 0 and wrap on a periodic
// one (fluca_tpu_torch.ops.banded.shifted). Unlike the TPU kernel, it
// does not rely on zero boundary coefficients to cancel wrapped reads.
// A0, C1, C2 are (3,N), the H arrays (N), in the type the instance
// computes in; p, b, w and out are (N0,N1,N2), C-contiguous, in the
// field type. Instances: f32 and f64, and bf16 (bf16 fields, float
// coefficients and arithmetic, one rounding at the store), the
// counterpart of the TPU kernel's bf16 instance under precond_dtype.
//
// What bounds it on an H100: memory traffic. Per cell it does about 20
// (apply) to 24 (smooth) flops against 8 to 16 bytes of f32 field
// traffic, far below the card's flop:byte ratio; at 512x256x256 one f32
// field is 134 MB, so an apply moves 268 MB (>= 80 us at 3.35 TB/s;
// 134 MB and 40 us in bf16).
//
// What the design does about it: one thread per cell reads each field
// once from device memory. Blocks of 32x8 cells cover one (j,k) plane,
// blockIdx.z walks the planes i, so the blocks in flight work on a few
// neighbouring planes and the six neighbour reads of p come from L1/L2
// (a 256x256 f32 plane is 256 KB; the L2 holds 50 MB). The 1-D
// coefficient arrays are a few KB and stay cached. The three modes are
// template instances, so the residual and the smoother are one pass
// each. A register march along i or shared-memory tiles are later work.
#include "stencil_common.cuh"

namespace {

template <typename T, int MODE>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
poisson3d_kernel(const T* __restrict__ p, const T* __restrict__ b,
                 const T* __restrict__ w,
                 const fluca::acc_t<T>* __restrict__ a0,
                 const fluca::acc_t<T>* __restrict__ c1,
                 const fluca::acc_t<T>* __restrict__ c2,
                 const fluca::acc_t<T>* __restrict__ h0,
                 const fluca::acc_t<T>* __restrict__ h1,
                 const fluca::acc_t<T>* __restrict__ h2, T* __restrict__ out,
                 int N0, int N1, int N2, int per0, int per1, int per2,
                 fluca::acc_t<T> omega) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int i = blockIdx.z;
    if (j >= N1 || k >= N2) return;
    const size_t idx = ((size_t)i * N1 + j) * N2 + k;
#define FLUCA_P(di, dj, dk) \
    fluca::load3d(p, i + (di), j + (dj), k + (dk), N0, N1, N2, per0, per1, per2)

    const C pc = F::load(p + idx);
    const C s0 = fluca::poisson3d_axis(a0, N0, i, FLUCA_P(-1, 0, 0), pc,
                                       FLUCA_P(1, 0, 0));
    const C s1 = fluca::poisson3d_axis(c1, N1, j, FLUCA_P(0, -1, 0), pc,
                                       FLUCA_P(0, 1, 0));
    const C s2 = fluca::poisson3d_axis(c2, N2, k, FLUCA_P(0, 0, -1), pc,
                                       FLUCA_P(0, 0, 1));
#undef FLUCA_P
    const C sp = fluca::poisson3d_sp(s0, s1, s2, __ldg(h0 + i), __ldg(h1 + j),
                                     __ldg(h2 + k));

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
           const void* a0, const void* c1, const void* c2, const void* h0,
           const void* h1, const void* h2, void* out, int N0, int N1, int N2,
           int per0, int per1, int per2, double omega, void* stream) {
    using C = fluca::acc_t<T>;
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid3d(N0, N1, N2);
    if (grid.y > fluca::kMaxGridYZ || grid.z > fluca::kMaxGridYZ)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* P = static_cast<const T*>(p);
    const T* B = static_cast<const T*>(b);
    const T* W = static_cast<const T*>(w);
    const C* A0 = static_cast<const C*>(a0);
    const C* C1 = static_cast<const C*>(c1);
    const C* C2 = static_cast<const C*>(c2);
    const C* H0 = static_cast<const C*>(h0);
    const C* H1 = static_cast<const C*>(h1);
    const C* H2 = static_cast<const C*>(h2);
    T* O = static_cast<T*>(out);
    const C om = static_cast<C>(omega);
    switch (mode) {
        case 0:
            poisson3d_kernel<T, 0><<<grid, block, 0, s>>>(
                P, B, W, A0, C1, C2, H0, H1, H2, O, N0, N1, N2, per0, per1,
                per2, om);
            break;
        case 1:
            poisson3d_kernel<T, 1><<<grid, block, 0, s>>>(
                P, B, W, A0, C1, C2, H0, H1, H2, O, N0, N1, N2, per0, per1,
                per2, om);
            break;
        case 2:
            poisson3d_kernel<T, 2><<<grid, block, 0, s>>>(
                P, B, W, A0, C1, C2, H0, H1, H2, O, N0, N1, N2, per0, per1,
                per2, om);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define FLUCA_POISSON3D_EXPORT(SFX, T)                                       \
    extern "C" int fluca_poisson3d_##SFX(                                    \
        int mode, const void* p, const void* b, const void* w,               \
        const void* a0, const void* c1, const void* c2, const void* h0,      \
        const void* h1, const void* h2, void* out, int N0, int N1, int N2,   \
        int per0, int per1, int per2, double omega, void* stream) {          \
        return launch<T>(mode, p, b, w, a0, c1, c2, h0, h1, h2, out, N0, N1, \
                         N2, per0, per1, per2, omega, stream);               \
    }

FLUCA_POISSON3D_EXPORT(f32, float)
FLUCA_POISSON3D_EXPORT(f64, double)
FLUCA_POISSON3D_EXPORT(bf16, __nv_bfloat16)

// ---------------------------------------------------------------------
// Halo instance (f32, f64): one shard's block, for the domain-decomposed
// step. Replaces the TPU kernel fluca_tpu/parallel/pallas_sharded.py
// build_poisson_sharded (3-D), which runs poisson3d_raw_call per shard
// with edge planes from ppermute. Same arithmetic as the kernel above,
// in the same order, so a block matches the unsharded kernel bit for
// bit; only the source of the neighbour reads differs
// (stencil_common.cuh halo_load). The coefficient arrays are per global
// index: each pointer is at the block's first index, A0, C1, C2 with
// rows ng apart. Bound and design as above; the edge planes add at most
// two planes per split axis to the bytes read.
namespace {

template <typename T, int MODE>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
poisson3d_halo_kernel(const fluca::HaloField<T, 3> p, const T* __restrict__ b,
                      const T* __restrict__ w, const T* __restrict__ a0,
                      const T* __restrict__ c1, const T* __restrict__ c2,
                      const T* __restrict__ h0, const T* __restrict__ h1,
                      const T* __restrict__ h2, T* __restrict__ out,
                      const fluca::HaloGeom<3> g, T omega) {
    using F = fluca::Field<T>;
    using C = T;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int i = blockIdx.z;
    if (j >= g.n[1] || k >= g.n[2]) return;
    const int pos[3] = {i, j, k};
    const long long idx = fluca::halo_offset(g, pos);
    const int N0 = g.ng[0], N1 = g.ng[1], N2 = g.ng[2];
#define FLUCA_P(ax, off) fluca::halo_load(p, g, pos, ax, off)

    const C pc = F::load(p.x + idx);
    const C s0 = fluca::poisson3d_axis(a0, N0, i, FLUCA_P(0, -1), pc, FLUCA_P(0, 1));
    const C s1 = fluca::poisson3d_axis(c1, N1, j, FLUCA_P(1, -1), pc, FLUCA_P(1, 1));
    const C s2 = fluca::poisson3d_axis(c2, N2, k, FLUCA_P(2, -1), pc, FLUCA_P(2, 1));
#undef FLUCA_P
    const C sp = fluca::poisson3d_sp(s0, s1, s2, __ldg(h0 + i), __ldg(h1 + j),
                                     __ldg(h2 + k));

    if (MODE == 0) {
        F::store(out + idx, sp);
    } else if (MODE == 1) {
        F::store(out + idx, F::load(b + idx) - sp);
    } else {
        F::store(out + idx,
                 pc + omega * F::load(w + idx) * (F::load(b + idx) - sp));
    }
}

// ptrs: p b w a0 c1 c2 h0 h1 h2 out | p's edge planes lo0 hi0 lo1 hi1
// lo2 hi2 (null on an axis that is not a halo axis); geom:
// read_halo_geom<3>.
template <typename T>
int launch_halo(int mode, const void* const* ptrs, const long long* geom,
                double omega, void* stream) {
    fluca::HaloGeom<3> g;
    fluca::read_halo_geom(geom, g);
    fluca::HaloField<T, 3> p;
    p.x = static_cast<const T*>(ptrs[0]);
    for (int a = 0; a < 3; ++a) {
        p.lo[a] = static_cast<const T*>(ptrs[10 + 2 * a]);
        p.hi[a] = static_cast<const T*>(ptrs[11 + 2 * a]);
    }
    const T* c[8];  // b w a0 c1 c2 h0 h1 h2
    for (int m = 0; m < 8; ++m) c[m] = static_cast<const T*>(ptrs[1 + m]);
    T* O = static_cast<T*>(const_cast<void*>(ptrs[9]));
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid3d(g.n[0], g.n[1], g.n[2]);
    if (grid.y > fluca::kMaxGridYZ || grid.z > fluca::kMaxGridYZ)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T om = static_cast<T>(omega);
    switch (mode) {
        case 0:
            poisson3d_halo_kernel<T, 0><<<grid, block, 0, s>>>(
                p, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], O, g, om);
            break;
        case 1:
            poisson3d_halo_kernel<T, 1><<<grid, block, 0, s>>>(
                p, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], O, g, om);
            break;
        case 2:
            poisson3d_halo_kernel<T, 2><<<grid, block, 0, s>>>(
                p, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], O, g, om);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define FLUCA_POISSON3D_HALO_EXPORT(SFX, T)                                 \
    extern "C" int fluca_poisson3d_halo_##SFX(                              \
        int mode, const void* const* ptrs, const long long* geom,           \
        double omega, void* stream) {                                       \
        return launch_halo<T>(mode, ptrs, geom, omega, stream);             \
    }

FLUCA_POISSON3D_HALO_EXPORT(f32, float)
FLUCA_POISSON3D_HALO_EXPORT(f64, double)
