// Fused 3-D momentum A-apply: (v0, v1, v2) -> A v with
// A = I + dt C(U0, v0f) - (mu dt / 2 rho) L, all three components in
// one pass.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// momentum3d_raw_calls (wrapped by build_momentum_apply_3d) and, in its
// halo instance, fluca_tpu/parallel/pallas_sharded.py
// build_momentum_sharded. As there, the coefficients are formed in the
// kernel from
//   - three per-axis band arrays B_a (27, N_a) in the row packing of
//     build_momentum_bands_3d: Laplacian rows L(c, off) = c*5 + off+2
//     (off -2..2, scaled by -mu dt / 2 rho) and convection rows
//     CV(var, lr, off) = 15 + var*6 + lr*3 + off+1 (var 0 tangential,
//     1 normal; lr 0 low face, 1 high face; scaled by dt);
//   - the 12 face arrays of the step, U0[a] and v0f[a][c], read where
//     they lie: the low factor of cell q along axis a is face q, the
//     high one face q+1 (face_shape: N+1 faces on a non-periodic axis;
//     N on a periodic one, where face N wraps to 0).
// For component c and each axis a (shifts along a):
//   nl_a = sum_o CV_a(1,0,o) v_a(q+o),  nr_a likewise with CV_a(1,1,o)
//   A v_c += sum_{o=-2..2} L_a(c,o) v_c(q+o)
//          + (Flv_a[c] + [c==a] FlU_a) nl_a + (Frv_a[c] + [c==a] FrU_a) nr_a
//          + [c!=a] (FlU_a sum_o CV_a(0,0,o) v_c(q+o)
//                    + FrU_a sum_o CV_a(0,1,o) v_c(q+o))
// (momentum_cell below, in that order; in the f32 and f64 instances
// every sum a chain of fused multiply-adds, in the bf16 instance every
// product and sum rounded on its own in the plain version's order,
// ops/cuda_stencil.py _momentum3d, so that it equals that version bit
// for bit). Neighbours outside a non-periodic axis read 0 and
// wrap on a periodic one (fluca_tpu_torch.ops.banded.shifted), the same
// on all three axes and for the +-2 rows.
//
// Instances: f32 and f64 (everything in one type), and bf16 (the
// reduced-precision ABF preconditioner's): bf16 v, face arrays and
// outputs, float bands and arithmetic, one rounding at the store. The
// halo instance (f32, f64) is one shard's block of a domain-decomposed
// grid: the same kernel template, whose reads past the block come from
// the edge planes of v and the hi face planes (stencil_common.cuh).
//
// What bounds it on an H100: memory traffic. Per cell it must read 3 v
// and 12 face factors (the high factor is the next cell's low one, so
// each face array streams once) and write 3 outputs: 18 streams, for
// ~200 flops, below the card's flop:byte ratio. At 512x256x256 f32 that
// is 18 x 134 MB = 2.4 GB, >= 0.7218 ms at 3.35 TB/s (half that, 0.3609
// ms, in bf16).
//
// What held the first design back: one thread per cell, and per cell
// ~150 loads where the data needs 21 streams: 99 loads of band rows (the
// axis-0 rows are uniform over a block, the axis-1/2 rows fixed for a
// thread), 6 neighbour loads that each decided the wrap or zero of three
// axes (in_axis, with a % on a periodic axis), face indices recomputed
// per axis, and every plane of v and of the faces fetched by three
// blocks. It was bound by instruction issue and load latency, not bytes:
// its bf16 instance, with half the bytes, took 34 % longer than f32
// (2.877 against 2.149 ms at 512x256x256).
//
// What this design does about it:
//   - a block owns a (rows x 32) tile of the (j, k) plane and marches
//     along axis 0 over `run` planes. v of planes i-1, i, i+1 stays in a
//     register ring and the axis-0 high face of plane i is carried as
//     the low face of plane i+1, so each plane of v and of the axis-0
//     faces is read once per block;
//   - the block's band rows are staged once in shared memory, 28 values
//     (the 27 rows padded) per index: `run` indices of axis 0, rows of
//     axis 1, 32 of axis 2; a cell reads its rows of an axis as 16-byte
//     vectors at fixed offsets. Which +-2 rows are nonzero is decided
//     once (per plane for axis 0, per thread for axes 1 and 2), so the
//     +-2 reads (wall rows only) cost one test per axis;
//   - the wrap or zero of each in-plane neighbour and high face is
//     resolved once per thread (Nb), of each axis-0 plane once per plane,
//     and every read of a plane is a load from a selected address with
//     its value selected after: no branch stands between the loads, so
//     the compiler issues all of a plane's loads before the first use
//     (with a branch around each load they go out one at a time). Each
//     thread has one cell: at the 16 warps per SM that its registers
//     allow (128 at most, from the launch bounds), the kernel is bound by
//     instruction issue, and two cells per thread needed twice the live
//     values;
//   - the bf16 instance reads one value per load, as f32 does: pair reads
//     along k (one 32-bit word for a cell and a k-neighbour) were slower
//     on the H100, their unpacking costing more issue than the load they
//     save;
//   - one per-cell arithmetic function (momentum_cell), with explicit
//     fused multiply-adds (f32, f64), for the unsharded and the halo
//     instances, so a halo block equals the unsharded kernel bit for bit. In the halo
//     instance the rows at a split axis-1 edge take a path of their own
//     (whole warps); the other halo reads are selects.
// The launch geometry (rows, run, grid, shared memory) comes from the
// host (fluca_tpu_torch.ops.cuda_stencil.momentum3d_launch_plan);
// the entry points check it against the shape.
#include <type_traits>

#include "stencil_common.cuh"

namespace {

constexpr int kBandRows = 27;
constexpr int kBandPitch = 28;    // a cell's band rows in shared memory, padded
                                  // to whole 16-byte vectors
constexpr int kLanes = 32;        // threads of a block along k (blockDim.x)
constexpr int kTileRows = 4;      // blockDim.y (MOMENTUM3D_TILE_ROWS of the host)
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block
constexpr int kMaxGridYZ = 65535;

__host__ __device__ constexpr int lap_row(int c, int off) {
    return c * 5 + off + 2;
}

__host__ __device__ constexpr int conv_row(int var, int lr, int off) {
    return 15 + var * 6 + lr * 3 + off + 1;
}

static_assert(conv_row(1, 1, 1) == kBandRows - 1, "band row packing");

// The kernel's inputs: the unsharded call is the block that is the
// whole grid, with wall and periodic axes only and no edge planes.
template <typename T>
struct Args {
    const fluca::acc_t<T>* band[3];  // (27, ng_a), at the block's first index
    fluca::HaloField<T, 3> v[3];     // cell fields (edge planes on halo axes)
    const T* fu[3];                  // U0[a] at the block's first face
    const T* fv[9];                  // v0f[a][c] at 3*a + c
    const T* fuh[3];                 // hi face plane of U0[a] (halo axes)
    const T* fvh[9];                 // hi face plane of v0f[a][c]
    T* out[3];
    fluca::HaloGeom<3> g;            // cell strides: st[2] == 1
    long long fst[3][3];             // fst[a][b]: strides of the axis-a face
                                     // arrays (fst[a][2] == 1)
    long long fest[3][3];            // fest[a][b]: strides of their hi planes
    int run;                         // planes per block
};

// One axis of one cell: its band rows (kBandPitch values in shared
// memory, 16-byte aligned), the +-2 rows that are nonzero (bit 2c:
// L(c, -2), bit 2c+1: L(c, 2)), the -1/+1 neighbours of v and the
// low/high factors.
template <typename C>
struct AxisIn {
    const C* B;
    unsigned far;
    C vm[3], vp[3];
    C FlU, FrU, Flv[3], Frv[3];
};

template <typename C>
__device__ __forceinline__ unsigned far_rows(const C* B) {
    unsigned m = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m |= (B[lap_row(c, -2)] != C(0)) << (2 * c);
        m |= (B[lap_row(c, 2)] != C(0)) << (2 * c + 1);
    }
    return m;
}

// A cell's band rows from shared memory, 16 bytes at a time.
__device__ __forceinline__ void band_rows(const float* B, float (&w)[kBandPitch]) {
#pragma unroll
    for (int q = 0; q < kBandPitch; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(B + q);
        w[q] = x.x;
        w[q + 1] = x.y;
        w[q + 2] = x.z;
        w[q + 3] = x.w;
    }
}
__device__ __forceinline__ void band_rows(const double* B, double (&w)[kBandPitch]) {
#pragma unroll
    for (int q = 0; q < kBandPitch; q += 2) {
        const double2 x = *reinterpret_cast<const double2*>(B + q);
        w[q] = x.x;
        w[q + 1] = x.y;
    }
}

// Axis A's terms of the three components, added to acc; far(c, off)
// reads v_c at the cell moved by off (+-2) along A, where FAR and the
// row's bit say so. The arithmetic is that of fields of type T
// (stencil_common.cuh madd): fused multiply-adds in the f32 and f64
// instances; in the bf16 one every product and sum rounded on its own,
// in its plain version's order, which adds the same terms in the same
// order but for the +-2 Laplacian rows.
template <int A, bool FAR, typename T, typename C, typename Far>
__device__ __forceinline__ void axis_sum(const C (&vc)[3], const AxisIn<C>& x,
                                         const Far& far, C (&acc)[3]) {
    using fluca::madd;
    using fluca::mult;
    using fluca::plus;
    C b[kBandPitch];
    band_rows(x.B, b);
    auto sum3 = [&](int r, C m, C c, C p) {  // r: the row of offset 0
        return madd<T>(b[r + 1], p, madd<T>(b[r], c, mult<T>(b[r - 1], m)));
    };
    // normal-variant sums on v_A, shared by the three components
    const C nl = sum3(conv_row(1, 0, 0), x.vm[A], vc[A], x.vp[A]);
    const C nr = sum3(conv_row(1, 1, 0), x.vm[A], vc[A], x.vp[A]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        C s;
        if constexpr (FAR && fluca::kPlainOrder<T>) {
            // the plain version sums the five Laplacian rows from -2 up; a
            // zero +-2 row adds a zero product
            const C m2 = (x.far & (1u << (2 * c))) ? far(c, -2) : C(0);
            const C p2 = (x.far & (2u << (2 * c))) ? far(c, 2) : C(0);
            s = madd<T>(b[lap_row(c, 2)], p2,
                        madd<T>(b[lap_row(c, 1)], x.vp[c],
                                madd<T>(b[lap_row(c, 0)], vc[c],
                                        madd<T>(b[lap_row(c, -1)], x.vm[c],
                                                mult<T>(b[lap_row(c, -2)], m2)))));
        } else {
            s = sum3(lap_row(c, 0), x.vm[c], vc[c], x.vp[c]);
            if (FAR && (x.far & (1u << (2 * c)))) s = madd<T>(b[lap_row(c, -2)], far(c, -2), s);
            if (FAR && (x.far & (2u << (2 * c)))) s = madd<T>(b[lap_row(c, 2)], far(c, 2), s);
        }
        if (c == A) {
            s = madd<T>(plus<T>(x.Frv[c], x.FrU), nr, madd<T>(plus<T>(x.Flv[c], x.FlU), nl, s));
        } else {
            const C tl = sum3(conv_row(0, 0, 0), x.vm[c], vc[c], x.vp[c]);
            const C tr = sum3(conv_row(0, 1, 0), x.vm[c], vc[c], x.vp[c]);
            s = madd<T>(x.FrU, tr,
                        madd<T>(x.FlU, tl, madd<T>(x.Frv[c], nr, madd<T>(x.Flv[c], nl, s))));
        }
        acc[c] = plus<T>(acc[c], s);
    }
}

// The +-2 rows are nonzero on wall rows only: one test per axis.
template <int A, typename T, typename C, typename Far>
__device__ __forceinline__ void axis_terms(const C (&vc)[3], const AxisIn<C>& x,
                                           const Far& far, C (&acc)[3]) {
    if (x.far)
        axis_sum<A, true, T>(vc, x, far, acc);
    else
        axis_sum<A, false, T>(vc, x, far, acc);
}

// The per-cell arithmetic of every instance: A v at one cell from its v
// (vc), the three axes' inputs and their +-2 readers, in this order, in
// the arithmetic of fields of type T.
template <typename T, typename C, typename F0, typename F1, typename F2>
__device__ __forceinline__ void momentum_cell(const C (&vc)[3], const AxisIn<C>& a0,
                                              const AxisIn<C>& a1, const AxisIn<C>& a2,
                                              const F0& far0, const F1& far1,
                                              const F2& far2, C (&acc)[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = vc[c];
    axis_terms<0, T>(vc, a0, far0, acc);
    axis_terms<1, T>(vc, a1, far1, acc);
    axis_terms<2, T>(vc, a2, far2, acc);
}

// One thread: the cell (j, k) of each plane of its block's run. HALO
// false compiles the edge-plane reads out. The bounds ask for 4 blocks of
// 128 threads per SM: at most 128 registers a thread, 16 warps an SM.
template <typename T, bool HALO>
__global__ void __launch_bounds__(kLanes * kTileRows, 4)
momentum3d_kernel(const Args<T> h) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    const fluca::HaloGeom<3>& g = h.g;
    const int n0 = g.n[0], n1 = g.n[1], n2 = g.n[2];
    // rows is blockDim.y, which the host checks is kTileRows: read as a
    // constant, the staging loops unroll and the f32 and bf16 instances
    // spill (slower on the H100)
    const int run = h.run, rows = blockDim.y;
    const int i0 = blockIdx.z * run, j0 = blockIdx.y * rows, k0 = blockIdx.x * kLanes;
    const int nrun = min(run, n0 - i0);

    // the block's band rows, kBandPitch per index: axis 0 [run], axis 1
    // [rows], axis 2 [kLanes]; then per plane of the run the nonzero +-2
    // rows of axis 0
    extern __shared__ __align__(16) unsigned char smem[];
    C* const sb0 = reinterpret_cast<C*>(smem);
    C* const sb1 = sb0 + kBandPitch * run;
    C* const sb2 = sb1 + kBandPitch * rows;
    unsigned* const sfar0 = reinterpret_cast<unsigned*>(sb2 + kBandPitch * kLanes);
    const int t = threadIdx.y * kLanes + threadIdx.x, nt = kLanes * rows;
    auto stage = [&](C* dst, const C* __restrict__ src, int ng, int first, int len,
                     int n) {
        for (int q = t; q < kBandPitch * len; q += nt) {
            const int r = q / len, x = q - r * len;
            dst[x * kBandPitch + r] =
                r < kBandRows && first + x < n ? __ldg(src + (size_t)r * ng + first + x) : C(0);
        }
    };
    stage(sb0, h.band[0], g.ng[0], i0, run, n0);
    stage(sb1, h.band[1], g.ng[1], j0, rows, n1);
    stage(sb2, h.band[2], g.ng[2], k0, kLanes, n2);
    __syncthreads();
    for (int x = t; x < run; x += nt) sfar0[x] = far_rows(sb0 + x * kBandPitch);
    __syncthreads();

    const int j = j0 + threadIdx.y, k = k0 + threadIdx.x;
    if (j >= n1 || k >= n2) return;
    const long long ctr = j * g.st[1] + k;
    const C* const B1 = sb1 + threadIdx.y * kBandPitch;
    const C* const B2 = sb2 + threadIdx.x * kBandPitch;
    const unsigned far1 = far_rows(B1), far2 = far_rows(B2);

    auto face = [&](int a, int f) { return f == 0 ? h.fu[a] : h.fv[3 * a + f - 1]; };
    auto face_hi = [&](int a, int f) { return f == 0 ? h.fuh[a] : h.fvh[3 * a + f - 1]; };

    // axis 0: plane q of v (i0 - 1 <= q <= n0) and face plane q
    // (i0 <= q <= n0), resolved per plane
    const bool per0 = g.mode[0] == fluca::kPeriodic, halo0 = HALO && g.mode[0] == fluca::kHalo;
    const long long ectr0 = HALO ? j * g.est[0][1] + k * g.est[0][2] : 0;
    const long long f0in = j * h.fst[0][1] + k;
    const long long f0hi = HALO ? j * h.fest[0][1] + k * h.fest[0][2] : 0;
    // in-plane neighbours and high faces, resolved once
    const fluca::Nb jm = fluca::resolve<1>(g, j, k, j - 1), jp = fluca::resolve<1>(g, j, k, j + 1);
    const fluca::Nb km = fluca::resolve<2>(g, j, k, k - 1), kp = fluca::resolve<2>(g, j, k, k + 1);
    // axis 1: low face (i, j) in the arrays; high face (i, j+1) in the
    // arrays, at row 0 (periodic) or on the hi plane (halo)
    const long long f1lo = j * h.fst[1][1] + k;
    const bool f1plane = HALO && j + 1 == n1 && g.mode[1] == fluca::kHalo;
    const long long f1hi = f1plane ? k * h.fest[1][2]
                           : j + 1 < n1 || g.mode[1] == fluca::kWall ? f1lo + h.fst[1][1]
                                                                     : k;
    // axis 2: low face k of the row; high face k+1: in the row, at its
    // start (periodic) or on the hi plane (halo)
    const long long f2lo = j * h.fst[2][1] + k;
    const bool f2plane = HALO && k + 1 == n2 && g.mode[2] == fluca::kHalo;
    const long long f2hi = f2plane ? j * h.fest[2][1]
                           : k + 1 < n2 || g.mode[2] == fluca::kWall ? f2lo + 1
                                                                     : j * h.fst[2][1];
    // the rows at a halo edge of axis 1 on a path of their own (a warp is
    // one row, so this is uniform over the warp); the other halo reads by
    // selects
    const bool edge = HALO && (jm.where >= fluca::kLo || jp.where >= fluca::kLo);

    auto body = [&](auto edge_c) {
        constexpr bool EDGE = decltype(edge_c)::value;
        auto plane_v = [&](int e, int q) -> C {
            const bool in = q >= 0 && q < n0;
            const int qq = in ? q : per0 ? q + (q < 0 ? n0 : -n0) : 0;
            const T* p = h.v[e].x + qq * g.st[0] + ctr;
            if (halo0 && !in) p = (q < 0 ? h.v[e].lo[0] : h.v[e].hi[0]) + ectr0;
            const C x = F::load(p);
            return !in && !per0 && !halo0 ? C(0) : x;
        };
        auto face0 = [&](int f, int q) {
            const bool wrap = q == n0 && g.mode[0] != fluca::kWall;
            const T* p = face(0, f) + (wrap ? 0 : q) * h.fst[0][0] + f0in;
            if (halo0 && wrap) p = face_hi(0, f) + f0hi;
            return F::load(p);
        };
        // v_e at an in-plane neighbour
        auto read_j = [&](int e, int i, long long pl, const fluca::Nb& nb) -> C {
            const T* p = h.v[e].x + pl + nb.off;
            if (EDGE && nb.where >= fluca::kLo)
                p = (nb.where == fluca::kLo ? h.v[e].lo[1] : h.v[e].hi[1]) + i * g.est[1][0] + nb.off;
            const C x = F::load(p);
            return nb.where == fluca::kZero ? C(0) : x;
        };
        auto read_k = [&](int e, int i, long long pl, const fluca::Nb& nb) -> C {
            const T* p = h.v[e].x + pl + nb.off;
            if (HALO && nb.where >= fluca::kLo)
                p = (nb.where == fluca::kLo ? h.v[e].lo[2] : h.v[e].hi[2]) + i * g.est[2][0] + nb.off;
            const C x = F::load(p);
            return nb.where == fluca::kZero ? C(0) : x;
        };

        C vr[3][3];     // v of planes i-1, i, i+1: [plane][e]
        C f0[2][4];     // axis-0 faces of plane i: [lo, hi][U0, v0f[0][c]]
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            vr[0][e] = plane_v(e, i0 - 1);
            vr[1][e] = plane_v(e, i0);
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) f0[0][f] = face0(f, i0);

        for (int ii = 0; ii < nrun; ++ii) {
            const int i = i0 + ii;
            const long long pl = i * g.st[0];
            // every load of the plane first
            C vjm[3], vjp[3], vkm[3], vkp[3], f1[2][4], f2[2][4];
#pragma unroll
            for (int e = 0; e < 3; ++e) {
                vr[2][e] = plane_v(e, i + 1);
                vjm[e] = read_j(e, i, pl, jm);
                vjp[e] = read_j(e, i, pl, jp);
                vkm[e] = read_k(e, i, pl, km);
                vkp[e] = read_k(e, i, pl, kp);
            }
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                f0[1][f] = face0(f, i + 1);
                const T* A1 = face(1, f) + i * h.fst[1][0];
                f1[0][f] = F::load(A1 + f1lo);
                f1[1][f] = F::load(EDGE && f1plane ? face_hi(1, f) + i * h.fest[1][0] + f1hi
                                                   : A1 + f1hi);
                const T* A2 = face(2, f) + i * h.fst[2][0];
                f2[0][f] = F::load(A2 + f2lo);
                f2[1][f] = F::load(HALO && f2plane ? face_hi(2, f) + i * h.fest[2][0] + f2hi
                                                   : A2 + f2hi);
            }

            // the three axes' terms in momentum_cell's order
            C acc[3];
            const int pos[3] = {i, j, k};
            auto axis_in = [&](const C* B, unsigned far, const C (&vm)[3], const C (&vp)[3],
                               const C (&lo)[4], const C (&hi)[4]) {
                AxisIn<C> a;
                a.B = B;
                a.far = far;
#pragma unroll
                for (int e = 0; e < 3; ++e) {
                    a.vm[e] = vm[e];
                    a.vp[e] = vp[e];
                }
                a.FlU = lo[0];
                a.FrU = hi[0];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    a.Flv[c] = lo[1 + c];
                    a.Frv[c] = hi[1 + c];
                }
                return a;
            };
            momentum_cell<T>(
                vr[1], axis_in(sb0 + ii * kBandPitch, sfar0[ii], vr[0], vr[2], f0[0], f0[1]),
                axis_in(B1, far1, vjm, vjp, f1[0], f1[1]),
                axis_in(B2, far2, vkm, vkp, f2[0], f2[1]),
                [&](int c, int off) { return fluca::halo_load(h.v[c], g, pos, 0, off); },
                [&](int c, int off) { return fluca::halo_load(h.v[c], g, pos, 1, off); },
                [&](int c, int off) { return fluca::halo_load(h.v[c], g, pos, 2, off); },
                acc);
#pragma unroll
            for (int c = 0; c < 3; ++c) F::store(h.out[c] + pl + ctr, acc[c]);

#pragma unroll
            for (int e = 0; e < 3; ++e) {
                vr[0][e] = vr[1][e];
                vr[1][e] = vr[2][e];
            }
#pragma unroll
            for (int f = 0; f < 4; ++f) f0[0][f] = f0[1][f];
        }
    };
    if constexpr (HALO) {
        if (edge) {
            body(std::true_type{});
            return;
        }
    }
    body(std::false_type{});
}

// ---------------------------------------------------------------------
// host side

template <typename T>
long long smem_bytes(int run, int rows) {
    return (long long)sizeof(fluca::acc_t<T>) * kBandPitch * (run + rows + kLanes) +
           (long long)sizeof(unsigned) * run;
}

// plan: grid x, y, z, rows (blockDim.y), run, dynamic shared memory
// bytes (fluca_tpu_torch.ops.cuda_stencil.momentum3d_launch_plan): it
// must tile the block's extents exactly and fit the card.
template <typename T>
bool plan_fits(const fluca::HaloGeom<3>& g, const int* plan) {
    const int gx = plan[0], gy = plan[1], gz = plan[2], rows = plan[3], run = plan[4],
              smem = plan[5];
    auto tiles = [](int n, int w) { return (n + w - 1) / w; };
    return rows == kTileRows && run >= 1 && g.n[0] >= 1 && g.n[1] >= 1 &&
           g.n[2] >= 1 && gx == tiles(g.n[2], kLanes) && gy == tiles(g.n[1], rows) &&
           gz == tiles(g.n[0], run) && gy <= kMaxGridYZ && gz <= kMaxGridYZ &&
           smem == smem_bytes<T>(run, rows) && smem <= kMaxSmem;
}

template <typename T, bool HALO>
int launch(Args<T> h, const int* plan, void* stream) {
    if (h.g.st[2] != 1 || h.fst[0][2] != 1 || h.fst[1][2] != 1 || h.fst[2][2] != 1 ||
        !plan_fits<T>(h.g, plan))
        return (int)cudaErrorInvalidConfiguration;
    auto kernel = momentum3d_kernel<T, HALO>;
    const int smem = plan[5];
    if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    h.run = plan[4];
    kernel<<<dim3(plan[0], plan[1], plan[2]), dim3(kLanes, plan[3]), smem,
             static_cast<cudaStream_t>(stream)>>>(h);
    return (int)cudaGetLastError();
}

// ptrs: b0 b1 b2 | v0 v1 v2 | U0[0..2] | v0f[a][c] (a-major, 9) |
// out0 out1 out2 — 21 device pointers; the whole grid, contiguous.
template <typename T>
int launch_grid(const void* const* ptrs, int N0, int N1, int N2, int per0, int per1,
                int per2, const int* plan, void* stream) {
    Args<T> h = {};
    const int N[3] = {N0, N1, N2}, per[3] = {per0, per1, per2};
    int m = 0;
    for (int a = 0; a < 3; ++a)
        h.band[a] = static_cast<const fluca::acc_t<T>*>(ptrs[m++]);
    for (int e = 0; e < 3; ++e) h.v[e].x = static_cast<const T*>(ptrs[m++]);
    for (int a = 0; a < 3; ++a) h.fu[a] = static_cast<const T*>(ptrs[m++]);
    for (int f = 0; f < 9; ++f) h.fv[f] = static_cast<const T*>(ptrs[m++]);
    for (int c = 0; c < 3; ++c) h.out[c] = static_cast<T*>(const_cast<void*>(ptrs[m++]));
    for (int a = 0; a < 3; ++a) {
        h.g.n[a] = h.g.ng[a] = N[a];
        h.g.mode[a] = per[a] ? fluca::kPeriodic : fluca::kWall;
        int d[3] = {N0, N1, N2};
        d[a] += per[a] ? 0 : 1;
        h.fst[a][0] = (long long)d[1] * d[2];
        h.fst[a][1] = d[2];
        h.fst[a][2] = 1;
    }
    h.g.st[0] = (long long)N1 * N2;
    h.g.st[1] = N2;
    h.g.st[2] = 1;
    return launch<T, false>(h, plan, stream);
}

// ptrs (51): b0 b1 b2 | v0 v1 v2 | U0[0..2] | v0f[a][c] (a-major, 9) |
// out0 out1 out2 | v[e] lo0 hi0 lo1 hi1 lo2 hi2 for e = 0..2 (18) |
// hi face planes of U0[0..2] | of v0f[a][c] (9); null where an axis is
// not a halo axis. geom: read_halo_geom<3>, then fst and fest (3 x 3
// each, row-major).
template <typename T>
int launch_block(const void* const* ptrs, const long long* geom, const int* plan,
                 void* stream) {
    Args<T> h = {};
    int m = fluca::read_halo_geom(geom, h.g);
    for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) h.fst[a][b] = geom[m++];
    for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) h.fest[a][b] = geom[m++];
    auto in = [&](int q) { return static_cast<const T*>(ptrs[q]); };
    int q = 0;
    for (int a = 0; a < 3; ++a) h.band[a] = in(q++);
    for (int e = 0; e < 3; ++e) h.v[e].x = in(q++);
    for (int a = 0; a < 3; ++a) h.fu[a] = in(q++);
    for (int f = 0; f < 9; ++f) h.fv[f] = in(q++);
    for (int c = 0; c < 3; ++c) h.out[c] = static_cast<T*>(const_cast<void*>(ptrs[q++]));
    for (int e = 0; e < 3; ++e)
        for (int a = 0; a < 3; ++a) {
            h.v[e].lo[a] = in(q++);
            h.v[e].hi[a] = in(q++);
        }
    for (int a = 0; a < 3; ++a) h.fuh[a] = in(q++);
    for (int f = 0; f < 9; ++f) h.fvh[f] = in(q++);
    return launch<T, true>(h, plan, stream);
}

}  // namespace

// plan: 6 ints (grid x, y, z, rows, run, shared memory bytes).
#define FLUCA_MOMENTUM3D_EXPORT(SFX, T)                                        \
    extern "C" int fluca_momentum3d_##SFX(const void* const* ptrs, int N0,     \
                                          int N1, int N2, int per0, int per1,  \
                                          int per2, const int* plan,           \
                                          void* stream) {                      \
        return launch_grid<T>(ptrs, N0, N1, N2, per0, per1, per2, plan,        \
                              stream);                                         \
    }

FLUCA_MOMENTUM3D_EXPORT(f32, float)
FLUCA_MOMENTUM3D_EXPORT(f64, double)
FLUCA_MOMENTUM3D_EXPORT(bf16, __nv_bfloat16)

// The halo instance (f32, f64): one shard's block, for the
// domain-decomposed step. The same kernel (momentum3d_kernel with HALO
// true), so a block matches the unsharded kernel bit for bit; only the
// source of the reads differs:
//   - v past the block along a halo axis comes from the edge planes, at
//     index -1 and n; the +-2 Laplacian rows are nonzero only on the
//     rows of a global wall, so a +-2 read past an edge plane meets a
//     zero band entry (and is skipped) when every local extent on a halo
//     axis is at least 3 (the wrapper refuses less; the plain version
//     asserts the zero);
//   - the band arrays are per global index: each pointer is at the
//     block's first index, rows ng apart;
//   - the face arrays are read in their own boxes (face q of the block
//     is global face box + q), with their own strides. The high factor
//     of the block's last cell along a halo axis is the face past the
//     block: it comes in as one hi face plane per face array of that
//     axis, the counterpart of the reference's lo_and_hilast and its
//     fe0/pa1/pa2 patches.
#define FLUCA_MOMENTUM3D_HALO_EXPORT(SFX, T)                                  \
    extern "C" int fluca_momentum3d_halo_##SFX(const void* const* ptrs,       \
                                               const long long* geom,         \
                                               const int* plan, void* stream) { \
        return launch_block<T>(ptrs, geom, plan, stream);                     \
    }

FLUCA_MOMENTUM3D_HALO_EXPORT(f32, float)
FLUCA_MOMENTUM3D_HALO_EXPORT(f64, double)
