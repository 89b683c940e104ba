// Fused 2-D pressure-Poisson stencil: apply, residual and damped-Jacobi
// smooth.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// poisson2d_raw_call (wrapped by _build_poisson_2d and
// build_poisson_{apply,residual,smooth}_2d) and, in its halo instance,
// fluca_tpu/parallel/pallas_sharded.py build_poisson_sharded (2-D),
// which runs poisson2d_raw_call per shard with edge rows and columns
// from ppermute. It computes
//
//   Sp[i,j] = CY[j] * sum_o RX[o,i] * p[i+o,j]
//           + RY[i] * sum_o CYb[o,j] * p[i,j+o]          (o in -1,0,1)
//
// and, by MODE, writes  Sp  |  b - Sp  |  p + omega * w * (b - Sp).
// Neighbours outside a non-periodic axis read 0 and wrap on a periodic
// one (fluca_tpu_torch.ops.banded.shifted), so no halo rows or columns
// are passed in. RX is (3,N0), RY (N0), CY (N1), CYb (3,N1), in the type
// the instance computes in; p, b, w and out are (N0,N1) in the field
// type. Instances: f32 and f64 (fields, coefficients and arithmetic in
// one type), and bf16 (bf16 p, b, w and out; float coefficients and
// arithmetic; one rounding, at the store), the counterpart of the TPU
// kernel's bf16 instance under precond_dtype. The halo instance (f32,
// f64) is one shard's block of a domain-decomposed grid: the same kernel
// template, whose reads past the block come from the edge rows and
// columns of p (stencil_common.cuh), so a block equals the unsharded
// kernel bit for bit.
//
// What bounds it on an H100: memory traffic. Per cell it does about 13
// (apply) to 17 (smooth) flops against 8, 12 or 16 bytes of f32 field
// traffic (half that in bf16), far below the card's flop:byte ratio; at
// 4096^2 an f32 apply moves 134 MB (>= 40 us at 3.35 TB/s). At the
// cavity's own sizes (256^2 and its coarser multigrid levels) a launch is
// bound by launch latency.
//
// What held the first design back (0.0973 ms for the apply at 4096^2
// f32, 41 % of its bound; bf16, with half the bytes, slower than f32 in
// every mode): one thread per cell in 32 x 8 blocks; four neighbour reads
// that each decided the wrap or zero of both axes with a branch (in_axis,
// with a % on a periodic axis) before the load, so the loads went out one
// at a time; 8 coefficient loads per cell where RX, RY are uniform along
// a row and CY, CYb fixed per column; and 4-byte (2-byte in bf16) loads,
// too little in flight per thread to cover the memory's latency.
//
// What this design does about it:
//   - a block of 32 x rows threads: each warp owns a strip of columns and
//     marches along axis 0 over `run` rows, p of rows i-1, i, i+1 in a
//     register ring, so each row of p is read once per warp;
//   - a lane holds VEC cells of a row (16 bytes where the shape and the
//     addresses allow, stencil_common.cuh Pack), read and written as one
//     access;
//   - j-1 and j+1 come from the neighbouring lanes (__shfl_up/down_sync);
//     the first and last lane of each warp hold the columns next to the
//     warp's strip and compute nothing (stencil_common.cuh Lane2D): their
//     reads hit the lines the neighbouring warps read;
//   - the wrap or zero of the columns is resolved once per thread, of the
//     rows once per row by selects (Rows2D); no branch stands between the
//     loads of a row. The halo instance reads an edge row through the
//     same pointer select and an edge column through one more load per
//     row, a pointer and a step resolved once per thread, in a loop
//     compiled only for blocks with a halo axis 1;
//   - the coefficients are staged once: RX's three values and RY per row
//     of the run in shared memory (one 16-byte read per row for f32), CY
//     and CYb per lane in registers; nothing but the fields is loaded per
//     cell. The first row's loads go out before the staging and its
//     barrier, and a block of one row (the coarse levels, where a launch
//     is bound by its latency) reads its row's four values with them and
//     stages nothing: it waits for one round of loads, not two;
//   - the sums are explicit fused multiply-adds in the order nvcc gave the
//     first design's expressions (sp below), so every instance equals it
//     bit for bit, and the step its results.
// The launch geometry (rows, run, VEC, grid, shared memory) comes from the
// host (fluca_tpu_torch.ops.cuda_stencil.poisson2d_launch_plan); the entry
// points check it against the shape and the addresses.
#include "stencil_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kMaxThreads = 512;
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Args {
    fluca::HaloField<T, 2> p;        // p (edge rows and columns on halo axes)
    const T* b;                      // residual and smooth, else null
    const T* w;                      // smooth, else null
    T* out;                          // b, w and out have p's strides
    const fluca::acc_t<T>* rx;       // (3, ng0), at the block's first row
    const fluca::acc_t<T>* ry;       // (ng0), at the block's first row
    const fluca::acc_t<T>* cy;       // (ng1), at the block's first column
    const fluca::acc_t<T>* cyb;      // (3, ng1), at the block's first column
    fluca::HaloGeom<2> g;            // g.st[1] == 1
    fluca::acc_t<T> omega;
    int run;                         // rows per block
};

// Sp of one cell: the first design's (RX0 up + RX1 pc + RX2 dn) CY + RY
// (CYb0 lf + CYb1 pc + CYb2 rt), contracted as nvcc contracted it.
template <typename C>
__device__ __forceinline__ C sp_of(const C (&a)[4], C cy, C c0, C c1, C c2, C up, C pc, C dn,
                                   C lf, C rt) {
    using fluca::mad;
    const C x = mad(a[2], dn, mad(a[0], up, a[1] * pc));
    const C y = mad(c2, rt, mad(c0, lf, c1 * pc));
    return mad(x, cy, a[3] * y);
}

// The march of one warp over its block's run, s0 the block's staged
// coefficients. ONE: the runs are one row long. EDGE1: the block has a
// halo axis 1, whose edge columns a lane at local column -1 or n1 reads.
template <typename T, int MODE, bool HALO, int VEC, bool ONE, bool EDGE1>
__device__ __forceinline__ void march(const Args<T>& h, const fluca::Lane2D<VEC, 1>& L,
                                      fluca::acc_t<T>* s0, int i0, int nrun) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    using V = fluca::Pack<T, VEC>;
    const fluca::HaloGeom<2>& g = h.g;
    const long long st0 = g.st[0];
    const fluca::Rows2D<T, HALO> R{h.p.x, h.p.lo[0], h.p.hi[0], st0, g.est[0][1], g.n[0],
                                   g.mode[0]};

    // the lane's column coefficients
    C cy[VEC], cb[3][VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const int j = L.own + k;
        cy[k] = __ldg(h.cy + j);
#pragma unroll
        for (int r = 0; r < 3; ++r) cb[r][k] = __ldg(h.cyb + (size_t)r * g.ng[1] + j);
    }
    // the edge column a lane at local column -1 or n1 reads, one pointer
    // and step (a lane that reads none: its own cells, value dropped)
    const T* eptr = h.p.x + L.col;
    long long estep = st0;
    if (EDGE1 && L.edge >= 0) {
        eptr = L.hi ? h.p.hi[1] : h.p.lo[1];
        estep = g.est[1][0];
    }

    auto row = [&](int q) {
        bool z;
        V v = V::load(R.at(q, L.col, z));
        v.zero_if(z || L.zero);
        return v;
    };
    // the loads of row i but for p's rows i-1 and i: row i+1 of p, b, w and
    // the edge column
    struct Loads {
        V pp, bb, ww;
        C e;
    };
    auto load = [&](int i) {
        Loads x;
        const long long o = i * st0 + L.own;
        x.pp = row(i + 1);
        if (MODE >= 1) x.bb = V::load(h.b + o);
        if (MODE == 2) x.ww = V::load(h.w + o);
        x.e = EDGE1 ? F::load(eptr + i * estep) : C(0);
        return x;
    };
    V pm = row(i0 - 1), pc = row(i0);
    const Loads first = load(i0);

    // RX's values and RY of the run, 4 per row: read with the first row's
    // loads where the run is one row (the coarse levels, where a launch is
    // bound by its latency), else staged in shared memory while those
    // loads are in flight
    C a0[4];
    if constexpr (ONE) {
#pragma unroll
        for (int r = 0; r < 3; ++r) a0[r] = __ldg(h.rx + (size_t)r * g.ng[0] + i0);
        a0[3] = __ldg(h.ry + i0);
    } else {
        const int t = threadIdx.y * kLanes + threadIdx.x;
        for (int q = t; q < 4 * nrun; q += kLanes * blockDim.y) {
            const int r = q / nrun, c = q - r * nrun;
            const C* src = r < 3 ? h.rx + (size_t)r * g.ng[0] : h.ry;
            s0[4 * c + r] = __ldg(src + i0 + c);
        }
        __syncthreads();
        fluca::plane_coeffs(s0, a0);
    }
    if (L.c0 >= g.n[1]) return;  // a warp past the last column

    // row i0 + ii from the loads x and the coefficients a: RX[-1], RX[0],
    // RX[+1], RY
    auto step = [&](int ii, const Loads& x, const C (&a)[4]) {
        V cur = pc;
        if (EDGE1) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) cur.v[k] = L.edge == k ? x.e : cur.v[k];
        }
        const C lf = __shfl_up_sync(kFull, cur.v[VEC - 1], 1);
        const C rt = __shfl_down_sync(kFull, cur.v[0], 1);
        V out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const C sp = sp_of(a, cy[k], cb[0][k], cb[1][k], cb[2][k], pm.v[k], pc.v[k],
                               x.pp.v[k], k == 0 ? lf : pc.v[k - 1],
                               k == VEC - 1 ? rt : pc.v[k + 1]);
            if (MODE == 0) {
                out.v[k] = sp;
            } else if (MODE == 1) {
                out.v[k] = x.bb.v[k] - sp;
            } else {
                out.v[k] = fluca::mad(h.omega * x.ww.v[k], x.bb.v[k] - sp, pc.v[k]);
            }
        }
        if (L.compute) out.store(h.out + (i0 + ii) * st0 + L.own);
        pm = pc;
        pc = x.pp;
    };
    step(0, first, a0);
#pragma unroll 1
    for (int ii = 1; ii < nrun; ++ii) {
        const Loads x = load(i0 + ii);  // every load of a row first
        C a[4];
        fluca::plane_coeffs(s0 + 4 * ii, a);
        step(ii, x, a);
    }
}

template <typename T, int MODE, bool HALO, int VEC, bool ONE>
__global__ void __launch_bounds__(kMaxThreads)
poisson2d_kernel(const Args<T> h) {
    extern __shared__ __align__(16) unsigned char smem[];
    fluca::acc_t<T>* const s0 = reinterpret_cast<fluca::acc_t<T>*>(smem);
    const int i0 = blockIdx.y * h.run;
    const int nrun = min(h.run, h.g.n[0] - i0);
    const fluca::Lane2D<VEC, 1> L(h.g, blockIdx.x * blockDim.y + threadIdx.y, threadIdx.x);
    if (HALO && h.g.mode[1] == fluca::kHalo)
        march<T, MODE, HALO, VEC, ONE, HALO>(h, L, s0, i0, nrun);
    else
        march<T, MODE, HALO, VEC, ONE, false>(h, L, s0, i0, nrun);
}

// ---------------------------------------------------------------------
// host side

// VEC cells per lane: 1, 2 or 4, at most 16 bytes of cells
template <typename T>
constexpr bool vec_ok(int vec) {
    return (vec == 1 || vec == 2 || vec == 4) && vec * sizeof(T) <= 16;
}

// plan: grid x, y, rows (blockDim.y), run, VEC, dynamic shared memory
// bytes (fluca_tpu_torch.ops.cuda_stencil.poisson2d_launch_plan): it must
// tile the block's extents exactly, fit the card, and VEC > 1 needs
// addresses and row strides aligned to VEC cells.
template <typename T>
bool plan_fits(const Args<T>& h, const int* plan) {
    const fluca::HaloGeom<2>& g = h.g;
    const int gx = plan[0], gy = plan[1], rows = plan[2], run = plan[3], vec = plan[4],
              smem = plan[5];
    if (!vec_ok<T>(vec)) return false;
    const int cols = (kLanes - 2 * ((1 + vec - 1) / vec)) * vec;
    auto tiles = [](long long n, long long w) { return (n + w - 1) / w; };
    bool ok = rows >= 1 && kLanes * rows <= kMaxThreads && run >= 1 && g.n[0] >= 1 &&
              g.n[1] >= 1 && g.n[1] % vec == 0 && gx == tiles(g.n[1], (long long)cols * rows) &&
              gy == tiles(g.n[0], run) && gy <= kMaxGridY &&
              smem == (int)(4 * sizeof(fluca::acc_t<T>)) * run && smem <= 48 * 1024;
    if (vec > 1) {
        const size_t align = sizeof(T) * vec;
        auto aligned = [&](const void* q) { return q == nullptr || (size_t)q % align == 0; };
        ok = ok && g.st[0] % vec == 0 && aligned(h.p.x) && aligned(h.b) && aligned(h.w) &&
             aligned(h.out);
        if (g.mode[0] == fluca::kHalo)
            ok = ok && g.est[0][1] == 1 && aligned(h.p.lo[0]) && aligned(h.p.hi[0]);
    }
    return ok;
}

template <typename T, bool HALO, int VEC, bool ONE>
void launch_one(int mode, const Args<T>& h, dim3 grid, dim3 block, int smem, cudaStream_t s) {
    switch (mode) {
        case 0:
            poisson2d_kernel<T, 0, HALO, VEC, ONE><<<grid, block, smem, s>>>(h);
            break;
        case 1:
            poisson2d_kernel<T, 1, HALO, VEC, ONE><<<grid, block, smem, s>>>(h);
            break;
        default:
            poisson2d_kernel<T, 2, HALO, VEC, ONE><<<grid, block, smem, s>>>(h);
            break;
    }
}

// one-row runs take their own instances: the staged code of longer runs
// ran 4-13 % slower at 4096^2 with the one-row path beside it behind a
// branch (H100, examples/kernels2d.py)
template <typename T, bool HALO, int VEC>
void launch_vec(int mode, const Args<T>& h, dim3 grid, dim3 block, int smem, cudaStream_t s) {
    if (h.run == 1)
        launch_one<T, HALO, VEC, true>(mode, h, grid, block, smem, s);
    else
        launch_one<T, HALO, VEC, false>(mode, h, grid, block, smem, s);
}

template <typename T, bool HALO>
int launch(int mode, Args<T> h, const int* plan, void* stream) {
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    if (h.g.st[1] != 1 || !plan_fits<T>(h, plan)) return (int)cudaErrorInvalidConfiguration;
    h.run = plan[3];
    const dim3 grid(plan[0], plan[1]), block(kLanes, plan[2]);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (plan[4]) {
        case 1:
            launch_vec<T, HALO, 1>(mode, h, grid, block, plan[5], s);
            break;
        case 2:
            launch_vec<T, HALO, 2>(mode, h, grid, block, plan[5], s);
            break;
        default:
            if constexpr (vec_ok<T>(4)) launch_vec<T, HALO, 4>(mode, h, grid, block, plan[5], s);
            break;
    }
    return (int)cudaGetLastError();
}

// ptrs[0..7]: p b w rx ry cy cyb out (b and w null where the mode does
// not read them)
template <typename T>
void read_ptrs(const void* const* ptrs, Args<T>& h) {
    using C = fluca::acc_t<T>;
    h.p.x = static_cast<const T*>(ptrs[0]);
    h.b = static_cast<const T*>(ptrs[1]);
    h.w = static_cast<const T*>(ptrs[2]);
    h.rx = static_cast<const C*>(ptrs[3]);
    h.ry = static_cast<const C*>(ptrs[4]);
    h.cy = static_cast<const C*>(ptrs[5]);
    h.cyb = static_cast<const C*>(ptrs[6]);
    h.out = static_cast<T*>(const_cast<void*>(ptrs[7]));
}

// The whole grid, contiguous: the block that is the grid, with wall and
// periodic axes only and no edge rows or columns.
template <typename T>
int launch_grid(int mode, const void* const* ptrs, int N0, int N1, int per0, int per1,
                double omega, const int* plan, void* stream) {
    Args<T> h = {};
    read_ptrs(ptrs, h);
    const int N[2] = {N0, N1}, per[2] = {per0, per1};
    for (int a = 0; a < 2; ++a) {
        h.g.n[a] = h.g.ng[a] = N[a];
        h.g.mode[a] = per[a] ? fluca::kPeriodic : fluca::kWall;
    }
    h.g.st[0] = N1;
    h.g.st[1] = 1;
    h.omega = static_cast<fluca::acc_t<T>>(omega);
    return launch<T, false>(mode, h, plan, stream);
}

// ptrs[0..7] as above, then p's edge planes lo0 hi0 lo1 hi1 (null on an
// axis that is not a halo axis); geom: read_halo_geom<2>.
template <typename T>
int launch_block(int mode, const void* const* ptrs, const long long* geom, double omega,
                 const int* plan, void* stream) {
    Args<T> h = {};
    read_ptrs(ptrs, h);
    fluca::read_halo_geom(geom, h.g);
    for (int a = 0; a < 2; ++a) {
        h.p.lo[a] = static_cast<const T*>(ptrs[8 + 2 * a]);
        h.p.hi[a] = static_cast<const T*>(ptrs[9 + 2 * a]);
    }
    h.omega = static_cast<fluca::acc_t<T>>(omega);
    return launch<T, true>(mode, h, plan, stream);
}

}  // namespace

// plan: 6 ints (grid x, y, rows, run, VEC, shared memory bytes).
#define FLUCA_POISSON2D_EXPORT(SFX, T)                                                   \
    extern "C" int fluca_poisson2d_##SFX(int mode, const void* const* ptrs, int N0,      \
                                         int N1, int per0, int per1, double omega,       \
                                         const int* plan, void* stream) {                \
        return launch_grid<T>(mode, ptrs, N0, N1, per0, per1, omega, plan, stream);      \
    }

FLUCA_POISSON2D_EXPORT(f32, float)
FLUCA_POISSON2D_EXPORT(f64, double)
FLUCA_POISSON2D_EXPORT(bf16, __nv_bfloat16)

// The halo instance (f32, f64): one shard's block, for the
// domain-decomposed step. The same kernel (poisson2d_kernel with HALO
// true); the coefficient arrays are per global index, each pointer at the
// block's first index, RX and CYb with rows ng apart; the edge rows and
// columns add at most two rows and two columns per block to the bytes
// read.
#define FLUCA_POISSON2D_HALO_EXPORT(SFX, T)                                              \
    extern "C" int fluca_poisson2d_halo_##SFX(int mode, const void* const* ptrs,         \
                                              const long long* geom, double omega,       \
                                              const int* plan, void* stream) {           \
        return launch_block<T>(mode, ptrs, geom, omega, plan, stream);                   \
    }

FLUCA_POISSON2D_HALO_EXPORT(f32, float)
FLUCA_POISSON2D_HALO_EXPORT(f64, double)
