// Fused 2-D momentum A-apply: (u, v) -> A (u, v) with
// A = I + dt C(U0, v0f) - (mu dt / 2 rho) L.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// momentum2d_raw_call (wrapped by build_momentum_apply_2d) and, in its
// halo instance, fluca_tpu/parallel/pallas_sharded.py
// build_momentum2d_sharded, which runs momentum2d_raw_call per shard with
// the axis-0 edge rows and the +-1 halo columns from ppermute. The
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
// one sums the products in float. The halo instance (f32, f64) is one
// shard's block: the same kernel template, whose reads past the block
// come from the edge rows and columns of u and v, so a block equals the
// unsharded kernel bit for bit. The plane stack is read in the block's
// box (planes ng0 * ng1 apart, rows as u's). The +-2 planes are nonzero
// only on the rows of a global wall, so a +-2 read that falls past the
// edge plane (local index -2 or n + 1) reads 0 and meets a zero
// coefficient when every local extent on a halo axis is at least 3 (the
// wrapper refuses less; the plain version asserts the zero).
//
// What bounds it on an H100: memory traffic. Per cell it reads 26
// coefficient planes plus u and v and writes two fields (30 streams,
// the same count as the TPU kernel's cost estimate, 120 bytes in f32) for
// about 50 flops, so it is bandwidth bound: at 4096^2 f32 an apply moves
// 2.0 GB (>= 0.60 ms at 3.35 TB/s). At 256^2 the 30 streams fit in the
// 50 MB L2, and a launch runs close to launch latency.
//
// What held the first design back (0.977 ms at 4096^2 f32, 61 % of its
// bound; bf16 0.983 ms, 31 %): one thread per cell, 16 neighbour reads
// that each decided the wrap or zero of both axes with a branch before the
// load, so they went out one at a time among the 26 plane loads.
//
// What this design does about it, as csrc/poisson2d.cu:
//   - each warp owns a strip of columns and marches along axis 0 over
//     `run` rows, u and v of rows i-2 .. i+2 in a register ring. On the
//     H100 runs of one row were the fastest (the plane streams dominate
//     the traffic, and the re-read rows of u and v come from L2), so the
//     host's plans take those; longer runs stay for the sweeps;
//   - the +-1 and +-2 columns come from lane shuffles; the lanes at each
//     end of a warp hold the two columns past its strip and compute
//     nothing (stencil_common.cuh Lane2D), their plane reads on a
//     computing lane's lines;
//   - the 26 planes are streamed once, coalesced, VEC cells per lane, all
//     of a row's loads before its arithmetic and stores; the wrap or zero
//     of the columns is resolved once per thread, of the rows by selects;
//   - the sums are explicit fused multiply-adds in the order nvcc gave the
//     first design's expressions (sum13), so every instance equals it bit
//     for bit. Forming the planes in the kernel from 1-D bands and face
//     factors (as the 3-D kernel does) would cut the 26 plane reads, but
//     changes what the kernel is called with.
// The launch geometry (rows, run, VEC, grid) comes from the host
// (fluca_tpu_torch.ops.cuda_stencil.momentum2d_launch_plan); the entry
// points check it against the shape and the addresses.
#include "stencil_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kMaxThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kPlanes = 26;
constexpr int kReach = 2;  // the stencil's reach along each axis
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Args {
    const T* W;                  // the plane stack, at the block's first cell
    fluca::HaloField<T, 2> u;    // u and v (edge rows and columns on halo axes)
    fluca::HaloField<T, 2> v;
    T* out_u;                    // u, v and the outputs share their strides
    T* out_v;
    fluca::HaloGeom<2> g;        // g.st[1] == 1
    int run;                     // rows per block
};

// A component of A(u, v) at one cell: the first design's sum of 13
// products, left to right, contracted as nvcc contracted it.
template <typename C>
__device__ __forceinline__ C sum13(const C (&w)[13], const C (&x)[13]) {
    C acc = fluca::mad(w[0], x[0], w[1] * x[1]);
#pragma unroll
    for (int k = 2; k < 13; ++k) acc = fluca::mad(w[k], x[k], acc);
    return acc;
}

// A field of the march: its rows i-2 .. i+2 of the lane's cells, and the
// kReach cells to each side of them in row i.
template <typename C, int VEC>
struct Ring {
    C r[5][VEC];        // rows i-2 .. i+2
    C left[kReach];     // columns js-1, js-2
    C right[kReach];    // columns js+VEC, js+VEC+1

    // cell k's neighbour d columns off (|d| <= kReach) in row i
    __device__ __forceinline__ C at(int k, int d) const {
        const int q = k + d;
        return q < 0 ? left[-q - 1] : q >= VEC ? right[q - VEC] : r[2][q];
    }
    // the side cells from the neighbouring lanes' row i, ``cur`` (the
    // lane's row i, an edge column's value in place)
    __device__ __forceinline__ void shuffle(const C (&cur)[VEC]) {
#pragma unroll
        for (int m = 0; m < kReach; ++m) {
            const int dl = (m + VEC) / VEC;  // lanes to the left of column js-1-m
            left[m] = __shfl_up_sync(kFull, cur[dl * VEC - 1 - m], dl);
            const int dr = 1 + m / VEC;      // lanes to the right of column js+VEC+m
            right[m] = __shfl_down_sync(kFull, cur[m % VEC], dr);
        }
    }
    __device__ __forceinline__ void roll() {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int k = 0; k < VEC; ++k) r[q][k] = r[q + 1][k];
    }
};

// The march of one warp over the block's run. EDGE1: the block has a halo
// axis 1, whose edge columns a lane at local column -1 or n1 reads.
template <typename T, bool HALO, int VEC, bool EDGE1>
__device__ __forceinline__ void march(const Args<T>& h, const fluca::Lane2D<VEC, kReach>& L,
                                      int i0, int nrun) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    using V = fluca::Pack<T, VEC>;
    const fluca::HaloGeom<2>& g = h.g;
    const long long st0 = g.st[0];
    const long long pst = (long long)g.ng[0] * g.ng[1];  // planes apart
    const fluca::HaloField<T, 2>* fs[2] = {&h.u, &h.v};
    fluca::Rows2D<T, HALO> R[2];
    const T* eptr[2];
    long long estep = st0;
    if (EDGE1 && L.edge >= 0) estep = g.est[1][0];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
        R[f] = {fs[f]->x, fs[f]->lo[0], fs[f]->hi[0], st0, g.est[0][1], g.n[0], g.mode[0]};
        // the edge column a lane at local column -1 or n1 reads (a lane that
        // reads none: its own cells, value dropped)
        eptr[f] = fs[f]->x + L.col;
        if (EDGE1 && L.edge >= 0) eptr[f] = L.hi ? fs[f]->hi[1] : fs[f]->lo[1];
    }
    auto row = [&](int f, int q, C (&dst)[VEC]) {
        bool z;
        V x = V::load(R[f].at(q, L.col, z));
        x.zero_if(z || L.zero);
#pragma unroll
        for (int k = 0; k < VEC; ++k) dst[k] = x.v[k];
    };
    Ring<C, VEC> ring[2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int q = 0; q < 4; ++q) row(f, i0 - 2 + q, ring[f].r[q + 1]);

#pragma unroll 1
    for (int ii = 0; ii < nrun; ++ii) {
        const int i = i0 + ii;
        const long long o = i * st0 + L.own;
        // every load of the row first: u and v of row i + 2, the planes
        // and the edge columns
#pragma unroll
        for (int f = 0; f < 2; ++f) ring[f].roll();
#pragma unroll
        for (int f = 0; f < 2; ++f) row(f, i + 2, ring[f].r[4]);
        V w[kPlanes];
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) w[k] = V::load(h.W + k * pst + o);
        C e[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) e[f] = EDGE1 ? F::load(eptr[f] + i * estep) : C(0);

#pragma unroll
        for (int f = 0; f < 2; ++f) {
            C cur[VEC];
#pragma unroll
            for (int k = 0; k < VEC; ++k) cur[k] = EDGE1 && L.edge == k ? e[f] : ring[f].r[2][k];
            ring[f].shuffle(cur);
        }
        const Ring<C, VEC>& U = ring[0];
        const Ring<C, VEC>& Vv = ring[1];
        V ou, ov;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const C uc = U.r[2][k], vc = Vv.r[2][k];
            const C wu[13] = {w[0].v[k],  w[1].v[k],  w[2].v[k],  w[3].v[k],  w[4].v[k],
                              w[5].v[k],  w[6].v[k],  w[7].v[k],  w[8].v[k],  w[18].v[k],
                              w[19].v[k], w[20].v[k], w[21].v[k]};
            const C xu[13] = {U.r[1][k],  uc,           U.r[3][k],   U.at(k, -1), uc,
                              U.at(k, 1), Vv.at(k, -1), vc,          Vv.at(k, 1), U.r[0][k],
                              U.r[4][k],  U.at(k, -2),  U.at(k, 2)};
            const C wv[13] = {w[9].v[k],  w[10].v[k], w[11].v[k], w[12].v[k], w[13].v[k],
                              w[14].v[k], w[15].v[k], w[16].v[k], w[17].v[k], w[22].v[k],
                              w[23].v[k], w[24].v[k], w[25].v[k]};
            const C xv[13] = {Vv.r[1][k],  vc,          Vv.r[3][k], Vv.at(k, -1), vc,
                              Vv.at(k, 1), U.r[1][k],   uc,         U.r[3][k],    Vv.r[0][k],
                              Vv.r[4][k],  Vv.at(k, -2), Vv.at(k, 2)};
            ou.v[k] = sum13(wu, xu);
            ov.v[k] = sum13(wv, xv);
        }
        if (L.compute) {
            ou.store(h.out_u + o);
            ov.store(h.out_v + o);
        }
    }
}

template <typename T, bool HALO, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
momentum2d_kernel(const Args<T> h) {
    const int i0 = blockIdx.y * h.run;
    const int nrun = min(h.run, h.g.n[0] - i0);
    const fluca::Lane2D<VEC, kReach> L(h.g, blockIdx.x * blockDim.y + threadIdx.y,
                                       threadIdx.x);
    if (L.c0 >= h.g.n[1]) return;  // a warp past the last column
    if (HALO && h.g.mode[1] == fluca::kHalo)
        march<T, HALO, VEC, HALO>(h, L, i0, nrun);
    else
        march<T, HALO, VEC, false>(h, L, i0, nrun);
}

// ---------------------------------------------------------------------
// host side

// VEC cells per lane: 1, 2 or 4, at most 16 bytes of cells
template <typename T>
constexpr bool vec_ok(int vec) {
    return (vec == 1 || vec == 2 || vec == 4) && vec * sizeof(T) <= 16;
}

// plan: grid x, y, rows (blockDim.y), run, VEC, dynamic shared memory
// bytes (0) (fluca_tpu_torch.ops.cuda_stencil.momentum2d_launch_plan): it
// must tile the block's extents exactly, fit the card, and VEC > 1 needs
// addresses and row strides aligned to VEC cells.
template <typename T>
bool plan_fits(const Args<T>& h, const int* plan) {
    const fluca::HaloGeom<2>& g = h.g;
    const int gx = plan[0], gy = plan[1], rows = plan[2], run = plan[3], vec = plan[4],
              smem = plan[5];
    if (!vec_ok<T>(vec)) return false;
    const int cols = (kLanes - 2 * ((kReach + vec - 1) / vec)) * vec;
    auto tiles = [](long long n, long long w) { return (n + w - 1) / w; };
    bool ok = rows >= 1 && kLanes * rows <= kMaxThreads && run >= 1 && g.n[0] >= 1 &&
              g.n[1] >= 1 && g.n[1] % vec == 0 && gx == tiles(g.n[1], (long long)cols * rows) &&
              gy == tiles(g.n[0], run) && gy <= kMaxGridY && smem == 0;
    if (vec > 1) {
        const size_t align = sizeof(T) * vec;
        auto aligned = [&](const void* q) { return q == nullptr || (size_t)q % align == 0; };
        ok = ok && g.st[0] % vec == 0 && g.ng[1] % vec == 0 && aligned(h.W) &&
             aligned(h.u.x) && aligned(h.v.x) && aligned(h.out_u) && aligned(h.out_v);
        if (g.mode[0] == fluca::kHalo)
            ok = ok && g.est[0][1] == 1 && aligned(h.u.lo[0]) && aligned(h.u.hi[0]) &&
                 aligned(h.v.lo[0]) && aligned(h.v.hi[0]);
    }
    return ok;
}

template <typename T, bool HALO>
int launch(Args<T> h, const int* plan, void* stream) {
    if (h.g.st[1] != 1 || !plan_fits<T>(h, plan)) return (int)cudaErrorInvalidConfiguration;
    h.run = plan[3];
    const dim3 grid(plan[0], plan[1]), block(kLanes, plan[2]);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (plan[4]) {
        case 1:
            momentum2d_kernel<T, HALO, 1><<<grid, block, 0, s>>>(h);
            break;
        case 2:
            momentum2d_kernel<T, HALO, 2><<<grid, block, 0, s>>>(h);
            break;
        default:
            if constexpr (vec_ok<T>(4)) momentum2d_kernel<T, HALO, 4><<<grid, block, 0, s>>>(h);
            break;
    }
    return (int)cudaGetLastError();
}

// ptrs[0..4]: W u v out_u out_v
template <typename T>
void read_ptrs(const void* const* ptrs, Args<T>& h) {
    h.W = static_cast<const T*>(ptrs[0]);
    h.u.x = static_cast<const T*>(ptrs[1]);
    h.v.x = static_cast<const T*>(ptrs[2]);
    h.out_u = static_cast<T*>(const_cast<void*>(ptrs[3]));
    h.out_v = static_cast<T*>(const_cast<void*>(ptrs[4]));
}

// The whole grid, contiguous: the block that is the grid, with wall and
// periodic axes only and no edge rows or columns.
template <typename T>
int launch_grid(const void* const* ptrs, int N0, int N1, int per0, int per1, const int* plan,
                void* stream) {
    Args<T> h = {};
    read_ptrs(ptrs, h);
    const int N[2] = {N0, N1}, per[2] = {per0, per1};
    for (int a = 0; a < 2; ++a) {
        h.g.n[a] = h.g.ng[a] = N[a];
        h.g.mode[a] = per[a] ? fluca::kPeriodic : fluca::kWall;
    }
    h.g.st[0] = N1;
    h.g.st[1] = 1;
    return launch<T, false>(h, plan, stream);
}

// ptrs[0..4] as above, then u's edge planes lo0 hi0 lo1 hi1 and v's (null
// on an axis that is not a halo axis); geom: read_halo_geom<2>.
template <typename T>
int launch_block(const void* const* ptrs, const long long* geom, const int* plan,
                 void* stream) {
    Args<T> h = {};
    read_ptrs(ptrs, h);
    fluca::read_halo_geom(geom, h.g);
    fluca::HaloField<T, 2>* fs[2] = {&h.u, &h.v};
    for (int e = 0; e < 2; ++e)
        for (int a = 0; a < 2; ++a) {
            fs[e]->lo[a] = static_cast<const T*>(ptrs[5 + 4 * e + 2 * a]);
            fs[e]->hi[a] = static_cast<const T*>(ptrs[6 + 4 * e + 2 * a]);
        }
    return launch<T, true>(h, plan, stream);
}

}  // namespace

// plan: 6 ints (grid x, y, rows, run, VEC, shared memory bytes).
#define FLUCA_MOMENTUM2D_EXPORT(SFX, T)                                                  \
    extern "C" int fluca_momentum2d_##SFX(const void* const* ptrs, int N0, int N1,       \
                                          int per0, int per1, const int* plan,           \
                                          void* stream) {                                \
        return launch_grid<T>(ptrs, N0, N1, per0, per1, plan, stream);                   \
    }

FLUCA_MOMENTUM2D_EXPORT(f32, float)
FLUCA_MOMENTUM2D_EXPORT(f64, double)
FLUCA_MOMENTUM2D_EXPORT(bf16, __nv_bfloat16)

// The halo instance (f32, f64): one shard's block, for the
// domain-decomposed step. The same kernel (momentum2d_kernel with HALO
// true); u and v take edge planes on each halo axis.
#define FLUCA_MOMENTUM2D_HALO_EXPORT(SFX, T)                                             \
    extern "C" int fluca_momentum2d_halo_##SFX(const void* const* ptrs,                  \
                                               const long long* geom, const int* plan,   \
                                               void* stream) {                           \
        return launch_block<T>(ptrs, geom, plan, stream);                                \
    }

FLUCA_MOMENTUM2D_HALO_EXPORT(f32, float)
FLUCA_MOMENTUM2D_HALO_EXPORT(f64, double)
