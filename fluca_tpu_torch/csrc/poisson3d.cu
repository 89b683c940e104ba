// Fused 3-D pressure-Poisson stencil (7-point): apply, residual and
// damped-Jacobi smooth.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// poisson3d_raw_call (wrapped by _build_poisson_3d and
// build_poisson_{apply,residual,smooth}_3d) and, in its halo instance,
// fluca_tpu/parallel/pallas_sharded.py build_poisson_sharded (3-D),
// which runs poisson3d_raw_call per shard with edge planes from
// ppermute. It computes
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
// A0, C1, C2 are (3, N), the H arrays (N), in the type the instance
// computes in; p, b, w and out are (N0, N1, N2) in the field type.
// Instances: f32 and f64, and bf16 (bf16 fields, float coefficients and
// arithmetic, one rounding at the store), the counterpart of the TPU
// kernel's bf16 instance under precond_dtype. The halo instance (f32,
// f64) is one shard's block of a domain-decomposed grid: the same kernel
// template, whose reads past the block come from the edge planes of p
// (stencil_common.cuh), so a block equals the unsharded kernel bit for
// bit.
//
// What bounds it on an H100: memory traffic. Per cell it does about 20
// (apply) to 24 (smooth) flops against 8 to 16 bytes of f32 field
// traffic, far below the card's flop:byte ratio; at 512x256x256 one f32
// field is 134 MB, so an apply moves 268 MB (>= 80 us at 3.35 TB/s;
// 134 MB and 40 us in bf16).
//
// What held the first design back (0.3594 ms for the apply at
// 512x256x256 f32, 22 % of its bound; bf16, with half the bytes, slower
// than f32): one thread per cell with blockIdx.z as the plane, so each
// plane of p was fetched by three blocks; six neighbour reads that each
// decided the wrap or zero of all three axes with a branch (in_axis, with
// a % on a periodic axis) before the load, so the loads went out one at a
// time; and 9 band and 3 width loads per cell where the axis-0 values are
// uniform over a plane and the axis-1/2 values fixed per thread. The
// probes (probe_poisson512) put the boundary logic alone at 38 % of the
// apply.
//
// What this design does about it:
//   - a block owns a (rows x 32) tile of the (j, k) plane and marches
//     along axis 0 over `run` planes; p of planes i-1, i, i+1 stays in a
//     register ring, so each plane of p is read once per block;
//   - the coefficients are staged once: A0's three values and H0 per
//     plane of the run in shared memory (one 16-byte read per plane for
//     f32), C1's and H1 per thread row and C2's and H2 per lane in
//     registers; nothing but the fields is loaded per cell;
//   - the wrap or zero of the j+-1 and k+-1 neighbours is resolved once
//     per thread (stencil_common.cuh resolve), of the plane i+1 once per
//     plane; every read is a load from an always valid address with its
//     value selected after, so no branch stands between the loads of a
//     plane and the compiler issues them together. The halo instance
//     resolves each neighbour, in the block or on an edge plane, into a
//     pointer and a step per plane once per thread, so its loop selects
//     no address per read. The unsharded loop is not unrolled (its
//     residual ran 16 % faster so);
//   - the in-plane neighbours come through L1: the lines of the j+-1 rows
//     are the ones the block's other warps read for their own cells;
//   - one arithmetic (poisson3d_axis, poisson3d_sp: explicit fused
//     multiply-adds) for every instance and for probes.cu's stripped
//     variants, so a halo block equals the unsharded kernel and the
//     "rebuilt" variant with true edges equals the apply bit for bit.
// The launch geometry (rows, run, grid, shared memory) comes from the host
// (fluca_tpu_torch.ops.cuda_stencil.poisson3d_launch_plan); the entry
// points check it against the shape.
#include "stencil_common.cuh"

namespace {

constexpr int kLanes = 32;       // threads of a block along k (blockDim.x)
constexpr int kMaxThreads = 512;
constexpr int kMaxGridYZ = 65535;

template <typename T>
struct Args {
    fluca::HaloField<T, 3> p;          // p (edge planes on halo axes)
    const T* b;                        // residual and smooth, else null
    const T* w;                        // smooth, else null
    T* out;                            // b, w and out have p's strides
    const fluca::acc_t<T>* band[3];    // A0, C1, C2: (3, ng_a), at the block's first index
    const fluca::acc_t<T>* h[3];       // H0, H1, H2, at the block's first index
    fluca::HaloGeom<3> g;              // g.st[2] == 1
    fluca::acc_t<T> omega;
    int run;                           // planes per block
};

// One thread: the cell (j, k) of each plane of its block's run. HALO
// false compiles the edge-plane reads out.
template <typename T, int MODE, bool HALO>
__global__ void __launch_bounds__(kMaxThreads)
poisson3d_kernel(const Args<T> h) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    const fluca::HaloGeom<3>& g = h.g;
    const int n0 = g.n[0], n1 = g.n[1], n2 = g.n[2];
    const int run = h.run, rows = blockDim.y;
    const int i0 = blockIdx.z * run, j0 = blockIdx.y * rows, k0 = blockIdx.x * kLanes;
    const int nrun = min(run, n0 - i0);

    // axis 0's values of the run, 4 per plane
    extern __shared__ __align__(16) unsigned char smem[];
    C* const s0 = reinterpret_cast<C*>(smem);
    const int t = threadIdx.y * kLanes + threadIdx.x;
    for (int q = t; q < 4 * nrun; q += kLanes * rows) {
        const int r = q / nrun, x = q - r * nrun;
        const C* src = r < 3 ? h.band[0] + (size_t)r * g.ng[0] : h.h[0];
        s0[4 * x + r] = __ldg(src + i0 + x);
    }
    __syncthreads();

    const int j = j0 + threadIdx.y, k = k0 + threadIdx.x;
    if (j >= n1 || k >= n2) return;
    const C* const B1 = h.band[1] + j;
    const C* const B2 = h.band[2] + k;
    const C c1m = __ldg(B1), c1c = __ldg(B1 + g.ng[1]), c1p = __ldg(B1 + 2 * g.ng[1]);
    const C c2m = __ldg(B2), c2c = __ldg(B2 + g.ng[2]), c2p = __ldg(B2 + 2 * g.ng[2]);
    const C hj = __ldg(h.h[1] + j), hk = __ldg(h.h[2] + k);
    const long long ctr = j * g.st[1] + k;

    // in-plane neighbours j-1, j+1, k-1, k+1, resolved once: in the block
    // (off: the offset in a plane of p), zero (off: the thread's own cell,
    // whose value is dropped) or, in the halo instance, on the lo/hi edge
    // plane of a halo axis (off: the offset in that plane)
    const fluca::Nb nbs[4] = {fluca::resolve<1>(g, j, k, j - 1), fluca::resolve<1>(g, j, k, j + 1),
                              fluca::resolve<2>(g, j, k, k - 1), fluca::resolve<2>(g, j, k, k + 1)};
    // axis 0: plane q of p (i0 - 1 <= q <= n0), resolved per plane
    const bool per0 = g.mode[0] == fluca::kPeriodic, halo0 = HALO && g.mode[0] == fluca::kHalo;
    const long long ectr0 = HALO ? j * g.est[0][1] + k * g.est[0][2] : 0;
    auto plane_p = [&](int q) -> C {
        const bool in = q >= 0 && q < n0;
        const int qq = in ? q : per0 ? q + (q < 0 ? n0 : -n0) : 0;
        const T* ptr = h.p.x + qq * g.st[0] + ctr;
        if (halo0 && !in) ptr = (q < 0 ? h.p.lo[0] : h.p.hi[0]) + ectr0;
        const C x = F::load(ptr);
        return !in && !per0 && !halo0 ? C(0) : x;
    };

    // plane i0 + ii, its in-plane neighbours read at nptr
    C pm = plane_p(i0 - 1), pc = plane_p(i0);
    auto plane = [&](int ii, const T* const (&nptr)[4]) {
        const long long pl = (i0 + ii) * g.st[0];
        // every load of the plane first
        const C pp = plane_p(i0 + ii + 1);
        C nb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const C x = F::load(nptr[q]);
            nb[q] = nbs[q].where == fluca::kZero ? C(0) : x;
        }
        const C bb = MODE >= 1 ? F::load(h.b + pl + ctr) : C(0);
        const C ww = MODE == 2 ? F::load(h.w + pl + ctr) : C(0);
        C a[4];
        fluca::plane_coeffs(s0 + 4 * ii, a);  // A0[-1], A0[0], A0[+1], H0

        const C sa = fluca::poisson3d_axis(a[0], a[1], a[2], pm, pc, pp);
        const C sb = fluca::poisson3d_axis(c1m, c1c, c1p, nb[0], pc, nb[1]);
        const C sc = fluca::poisson3d_axis(c2m, c2c, c2p, nb[2], pc, nb[3]);
        const C sp = fluca::poisson3d_sp(sa, sb, sc, a[3], hj, hk);
        T* const o = h.out + pl + ctr;
        if (MODE == 0) {
            F::store(o, sp);
        } else if (MODE == 1) {
            F::store(o, bb - sp);
        } else {
            F::store(o, fluca::mad(h.omega * ww, bb - sp, pc));
        }
        pm = pc;
        pc = pp;
    };
    if constexpr (HALO) {
        // a neighbour on an edge plane moves by that plane's stride along
        // axis 0: one pointer and step per neighbour, resolved once
        const T* nptr[4];
        long long step[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int ax = 1 + q / 2;
            const bool on_edge = nbs[q].where >= fluca::kLo;
            step[q] = on_edge ? g.est[ax][0] : g.st[0];
            nptr[q] = (on_edge ? (nbs[q].where == fluca::kLo ? h.p.lo[ax] : h.p.hi[ax]) : h.p.x) +
                      nbs[q].off + i0 * step[q];
        }
        for (int ii = 0; ii < nrun; ++ii) {
            plane(ii, nptr);
#pragma unroll
            for (int q = 0; q < 4; ++q) nptr[q] += step[q];
        }
    } else {
#pragma unroll 1
        for (int ii = 0; ii < nrun; ++ii) {
            const long long pl = (i0 + ii) * g.st[0];
            const T* const nptr[4] = {h.p.x + pl + nbs[0].off, h.p.x + pl + nbs[1].off,
                                      h.p.x + pl + nbs[2].off, h.p.x + pl + nbs[3].off};
            plane(ii, nptr);
        }
    }
}

// ---------------------------------------------------------------------
// host side

// plan: grid x, y, z, rows (blockDim.y), run, dynamic shared memory
// bytes (fluca_tpu_torch.ops.cuda_stencil.poisson3d_launch_plan): it
// must tile the block's extents exactly and fit the card.
template <typename T>
bool plan_fits(const fluca::HaloGeom<3>& g, const int* plan) {
    const int gx = plan[0], gy = plan[1], gz = plan[2], rows = plan[3], run = plan[4],
              smem = plan[5];
    auto tiles = [](int n, int w) { return (n + w - 1) / w; };
    return rows >= 1 && kLanes * rows <= kMaxThreads && run >= 1 && g.n[0] >= 1 &&
           g.n[1] >= 1 && g.n[2] >= 1 && gx == tiles(g.n[2], kLanes) &&
           gy == tiles(g.n[1], rows) && gz == tiles(g.n[0], run) && gy <= kMaxGridYZ &&
           gz <= kMaxGridYZ &&
           smem == (int)(4 * sizeof(fluca::acc_t<T>)) * run && smem <= 48 * 1024;
}

template <typename T, bool HALO>
int launch(int mode, Args<T> h, const int* plan, void* stream) {
    if (h.g.st[2] != 1 || !plan_fits<T>(h.g, plan)) return (int)cudaErrorInvalidConfiguration;
    h.run = plan[4];
    const dim3 grid(plan[0], plan[1], plan[2]), block(kLanes, plan[3]);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case 0:
            poisson3d_kernel<T, 0, HALO><<<grid, block, plan[5], s>>>(h);
            break;
        case 1:
            poisson3d_kernel<T, 1, HALO><<<grid, block, plan[5], s>>>(h);
            break;
        case 2:
            poisson3d_kernel<T, 2, HALO><<<grid, block, plan[5], s>>>(h);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// ptrs[0..9]: p b w a0 c1 c2 h0 h1 h2 out (b and w null where the mode
// does not read them)
template <typename T>
void read_ptrs(const void* const* ptrs, Args<T>& h) {
    using C = fluca::acc_t<T>;
    h.p.x = static_cast<const T*>(ptrs[0]);
    h.b = static_cast<const T*>(ptrs[1]);
    h.w = static_cast<const T*>(ptrs[2]);
    for (int a = 0; a < 3; ++a) {
        h.band[a] = static_cast<const C*>(ptrs[3 + a]);
        h.h[a] = static_cast<const C*>(ptrs[6 + a]);
    }
    h.out = static_cast<T*>(const_cast<void*>(ptrs[9]));
}

// The whole grid, contiguous: the block that is the grid, with wall and
// periodic axes only and no edge planes.
template <typename T>
int launch_grid(int mode, const void* const* ptrs, int N0, int N1, int N2, int per0,
                int per1, int per2, double omega, const int* plan, void* stream) {
    Args<T> h = {};
    read_ptrs(ptrs, h);
    const int N[3] = {N0, N1, N2}, per[3] = {per0, per1, per2};
    for (int a = 0; a < 3; ++a) {
        h.g.n[a] = h.g.ng[a] = N[a];
        h.g.mode[a] = per[a] ? fluca::kPeriodic : fluca::kWall;
    }
    h.g.st[0] = (long long)N1 * N2;
    h.g.st[1] = N2;
    h.g.st[2] = 1;
    h.omega = static_cast<fluca::acc_t<T>>(omega);
    return launch<T, false>(mode, h, plan, stream);
}

// ptrs[0..9] as above, then p's edge planes lo0 hi0 lo1 hi1 lo2 hi2
// (null on an axis that is not a halo axis); geom: read_halo_geom<3>.
template <typename T>
int launch_block(int mode, const void* const* ptrs, const long long* geom, double omega,
                 const int* plan, void* stream) {
    Args<T> h = {};
    read_ptrs(ptrs, h);
    fluca::read_halo_geom(geom, h.g);
    for (int a = 0; a < 3; ++a) {
        h.p.lo[a] = static_cast<const T*>(ptrs[10 + 2 * a]);
        h.p.hi[a] = static_cast<const T*>(ptrs[11 + 2 * a]);
    }
    h.omega = static_cast<fluca::acc_t<T>>(omega);
    return launch<T, true>(mode, h, plan, stream);
}

}  // namespace

// plan: 6 ints (grid x, y, z, rows, run, shared memory bytes).
#define FLUCA_POISSON3D_EXPORT(SFX, T)                                               \
    extern "C" int fluca_poisson3d_##SFX(int mode, const void* const* ptrs, int N0,  \
                                         int N1, int N2, int per0, int per1,         \
                                         int per2, double omega, const int* plan,    \
                                         void* stream) {                             \
        return launch_grid<T>(mode, ptrs, N0, N1, N2, per0, per1, per2, omega, plan, \
                              stream);                                               \
    }

FLUCA_POISSON3D_EXPORT(f32, float)
FLUCA_POISSON3D_EXPORT(f64, double)
FLUCA_POISSON3D_EXPORT(bf16, __nv_bfloat16)

// The halo instance (f32, f64): one shard's block, for the
// domain-decomposed step. The same kernel (poisson3d_kernel with HALO
// true); the coefficient arrays are per global index, each pointer at the
// block's first index, A0, C1, C2 with rows ng apart; the edge planes add
// at most two planes per split axis to the bytes read.
#define FLUCA_POISSON3D_HALO_EXPORT(SFX, T)                                          \
    extern "C" int fluca_poisson3d_halo_##SFX(int mode, const void* const* ptrs,     \
                                              const long long* geom, double omega,   \
                                              const int* plan, void* stream) {       \
        return launch_block<T>(mode, ptrs, geom, omega, plan, stream);               \
    }

FLUCA_POISSON3D_HALO_EXPORT(f32, float)
FLUCA_POISSON3D_HALO_EXPORT(f64, double)
