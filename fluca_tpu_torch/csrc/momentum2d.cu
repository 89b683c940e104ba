// Fused 2-D momentum A-apply: (u, v) -> A (u, v) with
// A = I + dt C(U0, v0f) - (mu dt / 2 rho) L.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// momentum2d_raw_call (wrapped by build_momentum_apply_2d). The
// coefficients are the (26, N0, N1) plane stack W that
// NSOperators.build_momentum_coeffs_stacked builds once per step:
//
//   out_u = sum_o W[0+o] u(i+o-1,j) + W[3+o] u(i,j+o-1) + W[6+o] v(i,j+o-1)
//         + W[18] u(i-2,j) + W[19] u(i+2,j) + W[20] u(i,j-2) + W[21] u(i,j+2)
//   out_v = sum_o W[9+o] v(i+o-1,j) + W[12+o] v(i,j+o-1) + W[15+o] u(i+o-1,j)
//         + W[22] v(i-2,j) + W[23] v(i+2,j) + W[24] v(i,j-2) + W[25] v(i,j+2)
//
// (o in 0,1,2). The +-2 planes carry the one-sided boundary rows of
// the Laplacian. Neighbours outside a non-periodic axis read 0 and wrap
// on a periodic one (fluca_tpu_torch.ops.banded.shifted); the TPU
// kernel's in-tile rolls and edge rows are not needed.
//
// Instances: f32 and f64, and bf16 (the reduced-precision ABF
// preconditioner's, where the step casts the plane stack to bf16): bf16
// planes and fields, float arithmetic, one rounding at the store. The
// TPU's bf16 instance multiplies the planes by the fields in bf16; this
// one sums the products in float.
//
// What bounds it on an H100: memory traffic. Per cell it reads 26
// coefficient planes plus u and v and writes two fields (30 streams,
// the same count as the TPU kernel's cost estimate) for about 56
// flops, so it is bandwidth bound. At 256^2 f32 the 30 streams are
// 7.9 MB, which fits in the 50 MB L2, so within a step it runs close
// to launch latency.
//
// What the design does about it: one thread per cell computes both
// outputs, so u and v and their neighbours are read once for both
// components; warps run along the contiguous axis for coalesced loads,
// and neighbour reads are served from L1/L2. Forming the coefficients
// in the kernel from 1-D bands and face factors (as the 3-D TPU kernel
// does) would cut the 26 plane reads, and is later work.
#include "stencil_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
momentum2d_kernel(const T* __restrict__ W, const T* __restrict__ u,
                  const T* __restrict__ v, T* __restrict__ out_u,
                  T* __restrict__ out_v, int N0, int N1, int per0,
                  int per1) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= N0 || j >= N1) return;
    const size_t n = (size_t)N0 * N1;
    const size_t idx = (size_t)i * N1 + j;
    const T* Wc = W + idx;
#define FLUCA_W(k) F::load(Wc + (size_t)(k) * n)
#define FLUCA_AT(x, di, dj) fluca::load2d(x, i + (di), j + (dj), N0, N1, per0, per1)

    const C uc = F::load(u + idx);
    const C vc = F::load(v + idx);

    const C ou = FLUCA_W(0) * FLUCA_AT(u, -1, 0) + FLUCA_W(1) * uc +
                 FLUCA_W(2) * FLUCA_AT(u, 1, 0) + FLUCA_W(3) * FLUCA_AT(u, 0, -1) +
                 FLUCA_W(4) * uc + FLUCA_W(5) * FLUCA_AT(u, 0, 1) +
                 FLUCA_W(6) * FLUCA_AT(v, 0, -1) + FLUCA_W(7) * vc +
                 FLUCA_W(8) * FLUCA_AT(v, 0, 1) + FLUCA_W(18) * FLUCA_AT(u, -2, 0) +
                 FLUCA_W(19) * FLUCA_AT(u, 2, 0) + FLUCA_W(20) * FLUCA_AT(u, 0, -2) +
                 FLUCA_W(21) * FLUCA_AT(u, 0, 2);
    const C ov = FLUCA_W(9) * FLUCA_AT(v, -1, 0) + FLUCA_W(10) * vc +
                 FLUCA_W(11) * FLUCA_AT(v, 1, 0) + FLUCA_W(12) * FLUCA_AT(v, 0, -1) +
                 FLUCA_W(13) * vc + FLUCA_W(14) * FLUCA_AT(v, 0, 1) +
                 FLUCA_W(15) * FLUCA_AT(u, -1, 0) + FLUCA_W(16) * uc +
                 FLUCA_W(17) * FLUCA_AT(u, 1, 0) + FLUCA_W(22) * FLUCA_AT(v, -2, 0) +
                 FLUCA_W(23) * FLUCA_AT(v, 2, 0) + FLUCA_W(24) * FLUCA_AT(v, 0, -2) +
                 FLUCA_W(25) * FLUCA_AT(v, 0, 2);
#undef FLUCA_W
#undef FLUCA_AT
    F::store(out_u + idx, ou);
    F::store(out_v + idx, ov);
}

template <typename T>
int launch(const void* w, const void* u, const void* v, void* out_u,
           void* out_v, int N0, int N1, int per0, int per1, void* stream) {
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    momentum2d_kernel<T><<<fluca::grid2d(N0, N1), block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(w), static_cast<const T*>(u),
        static_cast<const T*>(v), static_cast<T*>(out_u),
        static_cast<T*>(out_v), N0, N1, per0, per1);
    return (int)cudaGetLastError();
}

}  // namespace

#define FLUCA_MOMENTUM2D_EXPORT(SFX, T)                                     \
    extern "C" int fluca_momentum2d_##SFX(                                  \
        const void* w, const void* u, const void* v, void* out_u,           \
        void* out_v, int N0, int N1, int per0, int per1, void* stream) {    \
        return launch<T>(w, u, v, out_u, out_v, N0, N1, per0, per1,         \
                         stream);                                           \
    }

FLUCA_MOMENTUM2D_EXPORT(f32, float)
FLUCA_MOMENTUM2D_EXPORT(f64, double)
FLUCA_MOMENTUM2D_EXPORT(bf16, __nv_bfloat16)

// ---------------------------------------------------------------------
// Halo instance (f32, f64): one shard's block, for the domain-decomposed
// step. Replaces the TPU kernel fluca_tpu/parallel/pallas_sharded.py
// build_momentum2d_sharded, which runs momentum2d_raw_call per shard with
// the axis-0 edge rows and the +-1 halo columns from ppermute. Same
// arithmetic as the kernel above, in the same order, so a block matches
// the unsharded kernel bit for bit; only the source of the neighbour
// reads differs (stencil_common.cuh halo_load). The plane stack W is
// read in the block's box (planes ng0 * ng1 apart); u and v take edge
// planes on each halo axis. The +-2 planes are nonzero only on the rows
// of a global wall, so a +-2 read that falls past the edge plane (local
// index -2 or n + 1) reads 0 and meets a zero coefficient when every
// local extent on a halo axis is at least 3 (the wrapper refuses less;
// the plain version asserts the zero). Bound and design as above.
namespace {

template <typename T>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
momentum2d_halo_kernel(const T* __restrict__ W, const fluca::HaloField<T, 2> u,
                       const fluca::HaloField<T, 2> v, T* __restrict__ out_u,
                       T* __restrict__ out_v, const fluca::HaloGeom<2> g) {
    using F = fluca::Field<T>;
    using C = T;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= g.n[0] || j >= g.n[1]) return;
    const int pos[2] = {i, j};
    const size_t n = (size_t)g.ng[0] * g.ng[1];
    const long long idx = fluca::halo_offset(g, pos);
    const T* Wc = W + idx;
#define FLUCA_W(k) F::load(Wc + (size_t)(k) * n)
#define FLUCA_AT(x, di, dj) \
    ((di) != 0 ? fluca::halo_load(x, g, pos, 0, di) : fluca::halo_load(x, g, pos, 1, dj))

    const C uc = F::load(u.x + idx);
    const C vc = F::load(v.x + idx);

    const C ou = FLUCA_W(0) * FLUCA_AT(u, -1, 0) + FLUCA_W(1) * uc +
                 FLUCA_W(2) * FLUCA_AT(u, 1, 0) + FLUCA_W(3) * FLUCA_AT(u, 0, -1) +
                 FLUCA_W(4) * uc + FLUCA_W(5) * FLUCA_AT(u, 0, 1) +
                 FLUCA_W(6) * FLUCA_AT(v, 0, -1) + FLUCA_W(7) * vc +
                 FLUCA_W(8) * FLUCA_AT(v, 0, 1) + FLUCA_W(18) * FLUCA_AT(u, -2, 0) +
                 FLUCA_W(19) * FLUCA_AT(u, 2, 0) + FLUCA_W(20) * FLUCA_AT(u, 0, -2) +
                 FLUCA_W(21) * FLUCA_AT(u, 0, 2);
    const C ov = FLUCA_W(9) * FLUCA_AT(v, -1, 0) + FLUCA_W(10) * vc +
                 FLUCA_W(11) * FLUCA_AT(v, 1, 0) + FLUCA_W(12) * FLUCA_AT(v, 0, -1) +
                 FLUCA_W(13) * vc + FLUCA_W(14) * FLUCA_AT(v, 0, 1) +
                 FLUCA_W(15) * FLUCA_AT(u, -1, 0) + FLUCA_W(16) * uc +
                 FLUCA_W(17) * FLUCA_AT(u, 1, 0) + FLUCA_W(22) * FLUCA_AT(v, -2, 0) +
                 FLUCA_W(23) * FLUCA_AT(v, 2, 0) + FLUCA_W(24) * FLUCA_AT(v, 0, -2) +
                 FLUCA_W(25) * FLUCA_AT(v, 0, 2);
#undef FLUCA_W
#undef FLUCA_AT
    F::store(out_u + idx, ou);
    F::store(out_v + idx, ov);
}

// ptrs: W u v out_u out_v | u lo0 hi0 lo1 hi1 | v lo0 hi0 lo1 hi1 (null
// on an axis that is not a halo axis); geom: read_halo_geom<2>.
template <typename T>
int launch_halo(const void* const* ptrs, const long long* geom, void* stream) {
    fluca::HaloGeom<2> g;
    fluca::read_halo_geom(geom, g);
    fluca::HaloField<T, 2> f[2];
    for (int e = 0; e < 2; ++e) {
        f[e].x = static_cast<const T*>(ptrs[1 + e]);
        for (int a = 0; a < 2; ++a) {
            f[e].lo[a] = static_cast<const T*>(ptrs[5 + 4 * e + 2 * a]);
            f[e].hi[a] = static_cast<const T*>(ptrs[6 + 4 * e + 2 * a]);
        }
    }
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid2d(g.n[0], g.n[1]);
    if (grid.y > fluca::kMaxGridYZ) return (int)cudaErrorInvalidConfiguration;
    momentum2d_halo_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(ptrs[0]), f[0], f[1],
        static_cast<T*>(const_cast<void*>(ptrs[3])),
        static_cast<T*>(const_cast<void*>(ptrs[4])), g);
    return (int)cudaGetLastError();
}

}  // namespace

#define FLUCA_MOMENTUM2D_HALO_EXPORT(SFX, T)                                \
    extern "C" int fluca_momentum2d_halo_##SFX(                             \
        const void* const* ptrs, const long long* geom, void* stream) {     \
        return launch_halo<T>(ptrs, geom, stream);                          \
    }

FLUCA_MOMENTUM2D_HALO_EXPORT(f32, float)
FLUCA_MOMENTUM2D_HALO_EXPORT(f64, double)
