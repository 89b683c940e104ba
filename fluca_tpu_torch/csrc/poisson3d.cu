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
//     multiply-adds) for every instance, so a halo block equals the
//     unsharded kernel bit for bit.
// The kernel template lives in poisson3d.cuh, which probes.cu includes
// too: its stripped variants are instances of it, launched with the
// apply's geometry. The launch geometry (rows, run, grid, shared memory)
// comes from the host (fluca_tpu_torch.ops.cuda_stencil.
// poisson3d_launch_plan); the entry points check it against the shape.
#include "poisson3d.cuh"

namespace {

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
