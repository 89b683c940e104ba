// Fused 3-D interp/div/grad chain: the three stages around the momentum
// solve of the 3-D step, each one pass over the state.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_chain3d.py Chain3D._build
// (its pallas_call at :574) together with the XLA epilogue that writes
// the top face (:595-719):
//   coupled(Av, v, U, p): out_v = Av + G p, out_U = U - T v - R p,
//                         out_p = D U
//   pre(v, rU, rp):       U* = rU + T v, out_rp = rp - D rU - (D T) v
//   post(v*, U*, p):      out_v = v* - G p, out_U = U* - Gst p
// The coefficients come from three per-axis band arrays B_a
// (kRows, nfaces(a)) in the row packing of build_chain_bands
// (fluca_tpu_torch/ops/chain3d.py CHAIN_ROWS, mirrored by row() below):
// G, T, R, D, Gst and D T along axis a, G, R and Gst times dt/rho. Cell
// arrays have the cell shape N, the face arrays of axis d face_shape(d):
// N+1 faces along d on a non-periodic axis, N on a periodic one.
//
// One thread per index (i, j, k) of the box nfaces(0) x nfaces(1) x
// nfaces(2) writes every output that exists at that index: the cell
// outputs where the index is a cell, the face output of axis d where it
// is a face of axis d (below N on the other two axes). So the top face N
// of a non-periodic axis is written here, with the one-sided rows 21-23
// of the packing; the TPU kernel's slab tiles, rolls with edge planes,
// SMEM axis-0 bands and lo-form face arrays with an epilogue are not
// carried over. Neighbour reads follow fluca_tpu_torch.ops.banded.shifted:
// 0 outside a non-periodic axis, a wrap on a periodic one.
//
// Instances: f32 and f64, fields, bands and arithmetic in one type. The
// chain runs in the solver dtype; the bf16 branch of the ABF
// preconditioner never calls it (fluca_tpu/ns/cnlinear.py:685-724).
//
// What bounds it on an H100: memory traffic. coupled reads 10 arrays and
// writes 7, pre reads 7 and writes 4, post reads 7 and writes 6, with
// some 3-5 flops per element moved, far below the card's flop:byte ratio.
// At 512x256x256 f32 that is 17, 11 and 13 x 134 MB: at least 0.68, 0.44
// and 0.52 ms at 3.35 TB/s.
//
// What held the first design back (coupled 2.136 ms at 512x256x256 f32,
// 32 % of its bound; pre 40 %, post 51 %): one thread per index with
// blockIdx.z as the plane, so the planes at +-1, +-2 and -3 along axis 0
// came from L2, fetched by other blocks; and per read a band load, a test
// of the band for 0, an in_axis branch (with a % on a periodic axis) and
// the offset recomputed, so the loads went out one at a time.
//
// What this design does about it:
//   - a block owns a (rows x 32) tile of the (j, k) face box and marches
//     along axis 0 over `run` planes. The axis-0 neighbours a stage reads
//     at interior offsets stay in register rings: p for G, R and Gst, v_0
//     for T and D T, U_0 for D; each plane of them is read once per block;
//   - the block's band rows are staged once in shared memory, kRows per
//     index: `run` indices of axis 0, rows of axis 1, 32 of axis 2; a
//     thread reads its index's rows of an axis as 16-byte vectors;
//   - the rows that are nonzero only at a wall (G +-2, T -2 and +1, R -3
//     and +2, Gst -2 and +1) are flagged once per plane (axis 0) and once
//     per thread (axes 1 and 2); an unflagged one is neither read nor
//     multiplied, and a flagged axis-0 row outside the ring reads its
//     plane directly;
//   - the wrap or zero of every in-plane read is resolved once per thread
//     and of every plane once per plane: each read is a load from a
//     selected, always valid address with its value selected after, so no
//     branch stands between the loads of the interior rows; every load of
//     a plane is issued before its arithmetic and its stores (with stores
//     among the loads, post ran 1.8x slower at 512x256x256), and the
//     centre of p's in-plane taps is the ring's;
//   - the register budget is set per stage and type by the launch bounds
//     (min_blocks): more blocks on an SM beat more registers for the f32
//     stages, down to spills;
//   - every term is a fused multiply-add (fluca::mad), in the order of the
//     offsets, as the first design's contracted sums: the outputs equal
//     its bit for bit.
// The launch geometry (rows, run, grid, shared memory) comes from the host
// (fluca_tpu_torch.ops.cuda_stencil.chain3d_launch_plan); the entry points
// check it against the shape.
#include <type_traits>

#include "stencil_common.cuh"

namespace {

constexpr int kRows = 24;
constexpr int kPitch = 28;        // an index's rows in shared memory, padded so that
                                  // 8 lanes' 16-byte reads hit distinct banks
constexpr int kLanes = 32;        // threads of a block along k (blockDim.x)
constexpr int kTileRows = 4;      // blockDim.y (CHAIN3D_TILE_ROWS of the host)
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block
constexpr int kMaxGridYZ = 65535;

enum Op { kG, kT, kR, kD, kGst, kDT };
enum Stage { kCoupled, kPre, kPost };

// The offsets each operator's rows cover, and (operator, offset) -> row:
// rows 0..20 are the reference's 21-row packing, 21..23 the top-face
// offsets T -2, R -3 and Gst -2.
__host__ __device__ constexpr int lo_off(Op op) {
    return op == kG ? -2 : op == kT ? -2 : op == kR ? -3 : op == kD ? 0
                                                  : op == kGst ? -2 : -1;
}

__host__ __device__ constexpr int hi_off(Op op) {
    return op == kG ? 2 : op == kT ? 1 : op == kR ? 2 : op == kD ? 1
                                                : op == kGst ? 1 : 1;
}

__host__ __device__ constexpr int row(Op op, int off) {
    return op == kG     ? off + 2
           : op == kT   ? (off == -2 ? 21 : off + 6)
           : op == kR   ? (off == -3 ? 22 : off + 10)
           : op == kD   ? off + 13
           : op == kGst ? (off == -2 ? 23 : off + 16)
                        : off + 19;
}

static_assert(row(kGst, -2) == kRows - 1 && row(kDT, 1) == 20,
              "band row packing");

// The rows that are nonzero at a wall only, each with its bit of a far
// mask; -1 for the rows read at every index.
__host__ __device__ constexpr int far_bit(Op op, int off) {
    return op == kG     ? (off == -2 ? 0 : off == 2 ? 1 : -1)
           : op == kT   ? (off == -2 ? 2 : off == 1 ? 3 : -1)
           : op == kR   ? (off == -3 ? 4 : off == 2 ? 5 : -1)
           : op == kGst ? (off == -2 ? 6 : off == 1 ? 7 : -1)
                        : -1;
}

__host__ __device__ constexpr Op far_op(int bit) {
    return bit < 2 ? kG : bit < 4 ? kT : bit < 6 ? kR : kGst;
}

__host__ __device__ constexpr int far_off(int bit) {
    return bit == 0 ? -2 : bit == 1 ? 2 : bit == 2 ? -2 : bit == 3 ? 1
         : bit == 4 ? -3 : bit == 5 ? 2 : bit == 6 ? -2 : 1;
}

template <typename T>
struct Args {
    const T* band[3];  // (kRows, nf[a])
    const T* in[10];   // the stage's inputs, in the wrapper's order
    T* out[7];         // the stage's outputs
    int n[3];          // cells
    int nf[3];         // faces: n, or n + 1 on a non-periodic axis
    int per[3];
    int run;           // planes per block
};

// A resolved index along one axis: in range, wrapped on a periodic axis,
// or not there (ok false; idx then some valid index, whose value is
// dropped).
struct Res {
    int idx;
    bool ok;
};

__device__ __forceinline__ Res res(int q, int n, int per, int fallback) {
    if (q >= 0 && q < n) return {q, true};
    if (per) return {fluca::wrap_index(q, n), true};
    return {fallback, false};
}

// The kRows values of an index (kPitch apart in shared memory), 16 bytes
// at a time.
__device__ __forceinline__ void band_rows(const float* B, float (&w)[kRows]) {
#pragma unroll
    for (int q = 0; q < kRows; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(B + q);
        w[q] = x.x;
        w[q + 1] = x.y;
        w[q + 2] = x.z;
        w[q + 3] = x.w;
    }
}
__device__ __forceinline__ void band_rows(const double* B, double (&w)[kRows]) {
#pragma unroll
    for (int q = 0; q < kRows; q += 2) {
        const double2 x = *reinterpret_cast<const double2*>(B + q);
        w[q] = x.x;
        w[q + 1] = x.y;
    }
}

template <typename C>
__device__ __forceinline__ unsigned far_rows(const C* B) {
    unsigned m = 0;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit)
        m |= (unsigned)(B[row(far_op(bit), far_off(bit))] != C(0)) << bit;
    return m;
}

// sum_off B[row(OP, off)] x(off) over OP's offsets, in their order, each
// a fused multiply-add; rd(integral_constant<int, off>) reads x. A far
// row is read only where its bit of `far` is set.
template <Op OP, int OFF, typename C, typename Rd>
__device__ __forceinline__ void band_terms(const C (&B)[kRows], unsigned far, const Rd& rd,
                                           C& acc) {
    if constexpr (OFF <= hi_off(OP)) {
        constexpr int bit = far_bit(OP, OFF);
        if constexpr (bit < 0) {
            acc = fluca::mad(B[row(OP, OFF)], rd(std::integral_constant<int, OFF>{}), acc);
        } else {
            if (far & (1u << bit))
                acc = fluca::mad(B[row(OP, OFF)], rd(std::integral_constant<int, OFF>{}), acc);
        }
        band_terms<OP, OFF + 1>(B, far, rd, acc);
    }
}

template <Op OP, typename C, typename Rd>
__device__ __forceinline__ C band_sum(const C (&B)[kRows], unsigned far, const Rd& rd) {
    C acc = C(0);
    band_terms<OP, lo_off(OP)>(B, far, rd, acc);
    return acc;
}

// The values of one field at planes i + LO .. i + HI - 1 of the march;
// each plane loads i + HI (lead) and shifts.
template <typename C, int LO, int HI>
struct Ring {
    C v[HI - LO + 1];
    template <int OFF>
    __device__ __forceinline__ C at() const {
        static_assert(OFF >= LO && OFF <= HI, "ring offset");
        return v[OFF - LO];
    }
    __device__ __forceinline__ void shift() {
#pragma unroll
        for (int s = 0; s < HI - LO; ++s) v[s] = v[s + 1];
    }
};

// A field along an in-plane axis at the offsets LO..HI of an index, read
// up front (rd(integral_constant<int, off>)); other offsets (far rows)
// are read on demand.
template <typename C, int LO, int HI, typename Rd>
struct Taps {
    C v[HI - LO + 1];
    Rd rd;  // a lambda that captures by reference: copied, not referred to
    __device__ __forceinline__ explicit Taps(const Rd& r) : rd(r) {
        fill(std::make_integer_sequence<int, HI - LO + 1>{});
    }
    template <int... S>
    __device__ __forceinline__ void fill(std::integer_sequence<int, S...>) {
        ((v[S] = rd(std::integral_constant<int, LO + S>{})), ...);
    }
    template <typename O>
    __device__ __forceinline__ C operator()(O o) const {
        if constexpr (O::value >= LO && O::value <= HI) return v[O::value - LO];
        else return rd(o);
    }
};

template <int LO, int HI, typename Rd>
__device__ __forceinline__ auto taps(const Rd& rd) {
    using C = decltype(rd(std::integral_constant<int, LO>{}));
    return Taps<C, LO, HI, Rd>(rd);
}

// The blocks of 128 threads the launch bounds ask to keep on an SM, which
// caps the registers of a thread at 65536 / (128 * blocks): the budgets
// that ran each stage fastest on the H100 at 512x256x256 of 4, 5, 6 and 8
// blocks (128, 96, 80 and 64 registers; PERF.md section 6), f64 post at
// 4 for 128^3, where 5 was slower.
template <typename T, int S>
constexpr int min_blocks() {
    return sizeof(T) == 8 ? (S == kPre ? 5 : 4) : S == kCoupled ? 5 : S == kPre ? 6 : 8;
}

// One thread: the index (j, k) of the face box at each plane of its
// block's run.
template <typename T, int S>
__global__ void __launch_bounds__(kLanes * kTileRows, min_blocks<T, S>())
chain3d_kernel(const Args<T> g) {
    using C = T;
    const int n0 = g.n[0], n1 = g.n[1], n2 = g.n[2];
    const int f0 = g.nf[0], f1 = g.nf[1], f2 = g.nf[2];
    // rows is blockDim.y, which the host checks is kTileRows
    const int run = g.run, rows = blockDim.y;
    const int i0 = blockIdx.z * run, j0 = blockIdx.y * rows, k0 = blockIdx.x * kLanes;
    const int nrun = min(run, f0 - i0);

    // the block's band rows, kPitch per index: axis 0 [run], axis 1
    // [rows], axis 2 [kLanes]; then the far mask of axis 0 per plane
    extern __shared__ __align__(16) unsigned char smem[];
    C* const sb0 = reinterpret_cast<C*>(smem);
    C* const sb1 = sb0 + kPitch * run;
    C* const sb2 = sb1 + kPitch * rows;
    unsigned* const sfar0 = reinterpret_cast<unsigned*>(sb2 + kPitch * kLanes);
    const int t = threadIdx.y * kLanes + threadIdx.x, nt = kLanes * rows;
    auto stage = [&](C* dst, const C* __restrict__ src, int nf, int first, int len) {
        for (int q = t; q < kRows * len; q += nt) {
            const int r = q / len, x = q - r * len;
            dst[x * kPitch + r] = first + x < nf ? __ldg(src + (size_t)r * nf + first + x) : C(0);
        }
    };
    stage(sb0, g.band[0], f0, i0, run);
    stage(sb1, g.band[1], f1, j0, rows);
    stage(sb2, g.band[2], f2, k0, kLanes);
    __syncthreads();
    for (int x = t; x < run; x += nt) sfar0[x] = far_rows(sb0 + x * kPitch);
    __syncthreads();

    const int j = j0 + threadIdx.y, k = k0 + threadIdx.x;
    if (j >= f1 || k >= f2) return;
    const C* const B1s = sb1 + threadIdx.y * kPitch;
    const C* const B2s = sb2 + threadIdx.x * kPitch;
    const unsigned far1 = far_rows(B1s), far2 = far_rows(B2s);

    // which outputs the thread writes: cells where j, k are cells, the
    // faces of axis 0 there too, of axis 1 where k is a cell, of axis 2
    // where j is
    const bool jk = j < n1 && k < n2, k_cell = k < n2, j_cell = j < n1;
    const int jc = min(j, n1 - 1), kc = min(k, n2 - 1);
    // plane strides: cell arrays and the faces of axis 0, 1, 2
    const long long Pc = (long long)n1 * n2, P1 = (long long)f1 * n2, P2 = (long long)n1 * f2;
    const int ctr = jc * n2 + kc;
    // in-plane offsets of the cell reads at j - 3 .. j + 2 and k - 3 ..
    // k + 2, and which of them are there
    int o1[6], o2[6];
    unsigned m1 = 0, m2 = 0;
#pragma unroll
    for (int s = 0; s < 6; ++s) {
        const Res rj = res(j + s - 3, n1, g.per[1], jc);
        const Res rk = res(k + s - 3, n2, g.per[2], kc);
        o1[s] = rj.idx * n2 + kc;
        o2[s] = jc * n2 + rk.idx;
        m1 |= (unsigned)rj.ok << s;
        m2 |= (unsigned)rk.ok << s;
    }
    // the faces of axis 1 at j, j + 1 and of axis 2 at k, k + 1
    const int u1lo = j * n2 + kc, u1hi = res(j + 1, f1, g.per[1], j).idx * n2 + kc;
    const int u2lo = jc * f2 + k, u2hi = jc * f2 + res(k + 1, f2, g.per[2], k).idx;

    auto ld = [](const C* p) { return __ldg(p); };
    // a cell array x at plane i moved by OFF along axis 1 or 2
    auto rd1 = [&](const C* x, long long pl, auto o) -> C {
        constexpr int s = decltype(o)::value + 3;
        const C v = ld(x + pl + o1[s]);
        return (m1 >> s) & 1u ? v : C(0);
    };
    auto rd2 = [&](const C* x, long long pl, auto o) -> C {
        constexpr int s = decltype(o)::value + 3;
        const C v = ld(x + pl + o2[s]);
        return (m2 >> s) & 1u ? v : C(0);
    };
    // plane q of an array of extent n along axis 0 (plane stride P, at
    // in-plane offset o), 0 where it is not there
    auto plane = [&](const C* x, int q, int n, long long P, int o) -> C {
        const Res r = res(q, n, g.per[0], 0);
        const C v = ld(x + r.idx * P + o);
        return r.ok ? v : C(0);
    };

    // Each plane: every load first (the ring leads, the in-plane taps and
    // the plane's own inputs, at a clamped plane on the top face plane N0
    // of a non-periodic axis 0, where only the faces of axis 0 are
    // written), then the arithmetic, then the stores.
    if constexpr (S == kCoupled) {
        // in: Av[0..2] v[0..2] U[0..2] p; out: v[0..2] U[0..2] p
        const C* const p = g.in[9];
        const C* const v0 = g.in[3];
        const C* const U0 = g.in[6];
        Ring<C, -2, 1> rp;
        Ring<C, -1, 0> rv;
        Ring<C, 0, 1> ru;
#pragma unroll
        for (int s = 0; s < 3; ++s) rp.v[s] = plane(p, i0 - 2 + s, n0, Pc, ctr);
        rv.v[0] = plane(v0, i0 - 1, n0, Pc, ctr);
        ru.v[0] = plane(U0, i0, f0, Pc, ctr);
        for (int ii = 0; ii < nrun; ++ii) {
            const int i = i0 + ii, ic = min(i, n0 - 1);
            const long long pl = ic * Pc, pl1 = ic * P1, pl2 = ic * P2;
            rp.v[3] = plane(p, i + 1, n0, Pc, ctr);
            rv.v[1] = plane(v0, i, n0, Pc, ctr);
            ru.v[1] = plane(U0, i + 1, f0, Pc, ctr);
            const auto p1 = taps<-2, 1>([&](auto o) -> C {
                // the centre is the ring's, where the tap is there
                if constexpr (decltype(o)::value == 0) return (m1 >> 3) & 1u ? rp.template at<0>() : C(0);
                else return rd1(p, pl, o);
            });
            const auto p2 = taps<-2, 1>([&](auto o) -> C {
                // the centre is the ring's, where the tap is there
                if constexpr (decltype(o)::value == 0) return (m2 >> 3) & 1u ? rp.template at<0>() : C(0);
                else return rd2(p, pl, o);
            });
            const auto v11 = taps<-1, 0>([&](auto o) { return rd1(g.in[4], pl, o); });
            const auto v22 = taps<-1, 0>([&](auto o) { return rd2(g.in[5], pl, o); });
            const C u1a = ld(g.in[7] + pl1 + u1lo), u1b = ld(g.in[7] + pl1 + u1hi);
            const C u2a = ld(g.in[8] + pl2 + u2lo), u2b = ld(g.in[8] + pl2 + u2hi);
            C av[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) av[c] = ld(g.in[c] + pl + ctr);

            const unsigned far0 = sfar0[ii];
            // axis 0 reads: the rings, and the far rows' planes directly
            auto p0 = [&](auto o) -> C {
                constexpr int off = decltype(o)::value;
                if constexpr (off >= -2 && off <= 1) return rp.template at<off>();
                else return plane(p, i + off, n0, Pc, ctr);
            };
            auto v00 = [&](auto o) -> C {
                constexpr int off = decltype(o)::value;
                if constexpr (off >= -1 && off <= 0) return rv.template at<off>();
                else return plane(v0, i + off, n0, Pc, ctr);
            };
            auto u00 = [&](auto o) -> C { return ru.template at<decltype(o)::value>(); };
            C B[kRows];
            band_rows(sb0 + ii * kPitch, B);
            const C f0out = ru.template at<0>() - band_sum<kT>(B, far0, v00) -
                            band_sum<kR>(B, far0, p0);
            C vout[3], div = band_sum<kD>(B, 0u, u00);
            vout[0] = av[0] + band_sum<kG>(B, far0, p0);
            band_rows(B1s, B);
            vout[1] = av[1] + band_sum<kG>(B, far1, p1);
            div += band_sum<kD>(B, 0u, [&](auto o) { return decltype(o)::value == 0 ? u1a : u1b; });
            const C f1out = u1a - band_sum<kT>(B, far1, v11) - band_sum<kR>(B, far1, p1);
            band_rows(B2s, B);
            vout[2] = av[2] + band_sum<kG>(B, far2, p2);
            div += band_sum<kD>(B, 0u, [&](auto o) { return decltype(o)::value == 0 ? u2a : u2b; });
            const C f2out = u2a - band_sum<kT>(B, far2, v22) - band_sum<kR>(B, far2, p2);

            if (jk) g.out[3][(long long)i * Pc + ctr] = f0out;
            if (i < n0) {
                if (jk) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) g.out[c][pl + ctr] = vout[c];
                    g.out[6][pl + ctr] = div;
                }
                if (k_cell) g.out[4][pl1 + u1lo] = f1out;
                if (j_cell) g.out[5][pl2 + u2lo] = f2out;
            }
            rp.shift();
            rv.shift();
            ru.shift();
        }
    } else if constexpr (S == kPre) {
        // in: v[0..2] rU[0..2] rp; out: U*[0..2] rp
        const C* const v0 = g.in[0];
        const C* const rU0 = g.in[3];
        Ring<C, -1, 1> rv;
        Ring<C, 0, 1> ru;
        rv.v[0] = plane(v0, i0 - 1, n0, Pc, ctr);
        rv.v[1] = plane(v0, i0, n0, Pc, ctr);
        ru.v[0] = plane(rU0, i0, f0, Pc, ctr);
        for (int ii = 0; ii < nrun; ++ii) {
            const int i = i0 + ii, ic = min(i, n0 - 1);
            const long long pl = ic * Pc, pl1 = ic * P1, pl2 = ic * P2;
            rv.v[2] = plane(v0, i + 1, n0, Pc, ctr);
            ru.v[1] = plane(rU0, i + 1, f0, Pc, ctr);
            const auto v11 = taps<-1, 1>([&](auto o) { return rd1(g.in[1], pl, o); });
            const auto v22 = taps<-1, 1>([&](auto o) { return rd2(g.in[2], pl, o); });
            const C u1a = ld(g.in[4] + pl1 + u1lo), u1b = ld(g.in[4] + pl1 + u1hi);
            const C u2a = ld(g.in[5] + pl2 + u2lo), u2b = ld(g.in[5] + pl2 + u2hi);
            const C rpc = ld(g.in[6] + pl + ctr);

            const unsigned far0 = sfar0[ii];
            auto v00 = [&](auto o) -> C {
                constexpr int off = decltype(o)::value;
                if constexpr (off >= -1 && off <= 1) return rv.template at<off>();
                else return plane(v0, i + off, n0, Pc, ctr);
            };
            auto u00 = [&](auto o) -> C { return ru.template at<decltype(o)::value>(); };
            C B[kRows];
            band_rows(sb0 + ii * kPitch, B);
            const C f0out = ru.template at<0>() + band_sum<kT>(B, far0, v00);
            C acc = band_sum<kD>(B, 0u, u00) + band_sum<kDT>(B, 0u, v00);
            band_rows(B1s, B);
            acc += band_sum<kD>(B, 0u, [&](auto o) { return decltype(o)::value == 0 ? u1a : u1b; }) +
                   band_sum<kDT>(B, 0u, v11);
            const C f1out = u1a + band_sum<kT>(B, far1, v11);
            band_rows(B2s, B);
            acc += band_sum<kD>(B, 0u, [&](auto o) { return decltype(o)::value == 0 ? u2a : u2b; }) +
                   band_sum<kDT>(B, 0u, v22);
            const C f2out = u2a + band_sum<kT>(B, far2, v22);

            if (jk) g.out[0][(long long)i * Pc + ctr] = f0out;
            if (i < n0) {
                if (jk) g.out[3][pl + ctr] = rpc - acc;
                if (k_cell) g.out[1][pl1 + u1lo] = f1out;
                if (j_cell) g.out[2][pl2 + u2lo] = f2out;
            }
            rv.shift();
            ru.shift();
        }
    } else {
        // in: v*[0..2] U*[0..2] p; out: v[0..2] U[0..2]
        const C* const p = g.in[6];
        Ring<C, -1, 1> rp;
        rp.v[0] = plane(p, i0 - 1, n0, Pc, ctr);
        rp.v[1] = plane(p, i0, n0, Pc, ctr);
        for (int ii = 0; ii < nrun; ++ii) {
            const int i = i0 + ii, ic = min(i, n0 - 1);
            const long long pl = ic * Pc, pl1 = ic * P1, pl2 = ic * P2;
            const long long f = (long long)i * Pc + ctr;
            rp.v[2] = plane(p, i + 1, n0, Pc, ctr);
            const auto p1 = taps<-1, 1>([&](auto o) -> C {
                // the centre is the ring's, where the tap is there
                if constexpr (decltype(o)::value == 0) return (m1 >> 3) & 1u ? rp.template at<0>() : C(0);
                else return rd1(p, pl, o);
            });
            const auto p2 = taps<-1, 1>([&](auto o) -> C {
                // the centre is the ring's, where the tap is there
                if constexpr (decltype(o)::value == 0) return (m2 >> 3) & 1u ? rp.template at<0>() : C(0);
                else return rd2(p, pl, o);
            });
            C vs[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) vs[c] = ld(g.in[c] + pl + ctr);
            const C us0 = ld(g.in[3] + f);
            const C us1 = ld(g.in[4] + pl1 + u1lo);
            const C us2 = ld(g.in[5] + pl2 + u2lo);

            const unsigned far0 = sfar0[ii];
            auto p0 = [&](auto o) -> C {
                constexpr int off = decltype(o)::value;
                if constexpr (off >= -1 && off <= 1) return rp.template at<off>();
                else return plane(p, i + off, n0, Pc, ctr);
            };
            C B[kRows], vout[3];
            band_rows(sb0 + ii * kPitch, B);
            const C f0out = us0 - band_sum<kGst>(B, far0, p0);
            vout[0] = vs[0] - band_sum<kG>(B, far0, p0);
            band_rows(B1s, B);
            vout[1] = vs[1] - band_sum<kG>(B, far1, p1);
            const C f1out = us1 - band_sum<kGst>(B, far1, p1);
            band_rows(B2s, B);
            vout[2] = vs[2] - band_sum<kG>(B, far2, p2);
            const C f2out = us2 - band_sum<kGst>(B, far2, p2);

            if (jk) g.out[3][f] = f0out;
            if (i < n0) {
                if (jk) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) g.out[c][pl + ctr] = vout[c];
                }
                if (k_cell) g.out[4][pl1 + u1lo] = f1out;
                if (j_cell) g.out[5][pl2 + u2lo] = f2out;
            }
            rp.shift();
        }
    }
}

// ---------------------------------------------------------------------
// host side

template <typename T>
long long smem_bytes(int run, int rows) {
    return (long long)sizeof(T) * kPitch * (run + rows + kLanes) + (long long)sizeof(unsigned) * run;
}

// plan: grid x, y, z, rows (blockDim.y), run, dynamic shared memory
// bytes (fluca_tpu_torch.ops.cuda_stencil.chain3d_launch_plan): it must
// tile the face box exactly and fit the card.
template <typename T>
bool plan_fits(const int nf[3], const int* plan) {
    const int gx = plan[0], gy = plan[1], gz = plan[2], rows = plan[3], run = plan[4],
              smem = plan[5];
    auto tiles = [](int n, int w) { return (n + w - 1) / w; };
    return rows == kTileRows && run >= 1 && gx == tiles(nf[2], kLanes) &&
           gy == tiles(nf[1], rows) && gz == tiles(nf[0], run) && gy <= kMaxGridYZ &&
           gz <= kMaxGridYZ && smem == smem_bytes<T>(run, rows) && smem <= kMaxSmem;
}

// ptrs: b0 b1 b2 | the stage's inputs | its outputs (coupled 10 | 7,
// pre 7 | 4, post 7 | 6), device pointers in the order of
// fluca_tpu_torch.ops.cuda_stencil.CHAIN_STAGES.
template <typename T, int S>
int launch(const void* const* ptrs, int N0, int N1, int N2, int per0, int per1, int per2,
           const int* plan, void* stream) {
    constexpr int n_in = S == kCoupled ? 10 : 7;
    constexpr int n_out = S == kCoupled ? 7 : S == kPre ? 4 : 6;
    Args<T> g = {};
    int m = 0;
    for (int a = 0; a < 3; ++a) g.band[a] = static_cast<const T*>(ptrs[m++]);
    for (int e = 0; e < n_in; ++e) g.in[e] = static_cast<const T*>(ptrs[m++]);
    for (int e = 0; e < n_out; ++e) g.out[e] = static_cast<T*>(const_cast<void*>(ptrs[m++]));
    const int n[3] = {N0, N1, N2};
    const int per[3] = {per0, per1, per2};
    for (int a = 0; a < 3; ++a) {
        if (n[a] < 1) return (int)cudaErrorInvalidValue;
        g.n[a] = n[a];
        g.per[a] = per[a];
        g.nf[a] = n[a] + (per[a] ? 0 : 1);
    }
    if ((long long)g.nf[1] * g.nf[2] > 0x7fffffffLL || !plan_fits<T>(g.nf, plan))
        return (int)cudaErrorInvalidConfiguration;
    auto kernel = chain3d_kernel<T, S>;
    const int smem = plan[5];
    if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    g.run = plan[4];
    kernel<<<dim3(plan[0], plan[1], plan[2]), dim3(kLanes, plan[3]), smem,
             static_cast<cudaStream_t>(stream)>>>(g);
    return (int)cudaGetLastError();
}

}  // namespace

// plan: 6 ints (grid x, y, z, rows, run, shared memory bytes).
#define FLUCA_CHAIN3D_STAGE(NAME, STAGE, SFX, T)                                      \
    extern "C" int fluca_chain3d_##NAME##_##SFX(const void* const* ptrs, int N0,      \
                                                int N1, int N2, int per0, int per1,   \
                                                int per2, const int* plan,            \
                                                void* stream) {                       \
        return launch<T, STAGE>(ptrs, N0, N1, N2, per0, per1, per2, plan, stream);    \
    }

#define FLUCA_CHAIN3D_EXPORT(SFX, T)               \
    FLUCA_CHAIN3D_STAGE(coupled, kCoupled, SFX, T) \
    FLUCA_CHAIN3D_STAGE(pre, kPre, SFX, T)         \
    FLUCA_CHAIN3D_STAGE(post, kPost, SFX, T)

FLUCA_CHAIN3D_EXPORT(f32, float)
FLUCA_CHAIN3D_EXPORT(f64, double)
