// The bench's and the memory probes' kernels: a streaming copy, the copy
// with two in-plane neighbour reads, and the 3-D Poisson apply with its
// neighbour reads or its arithmetic stripped. float32 only: every probe
// runs on float32 fields.
//
// Replaces the TPU kernels of the repo's bench and probe scripts:
// - copy_scale, o = a * 1.0000001f over one or two (input, output) pairs
//   of one shape, `rows` leading-axis rows per thread block: the copy
//   pallas_calls of bench.py spmv_roofline (:139, 128-row blocks of a
//   4096^2 field) and poisson3d_roofline (:542, 8-plane slabs of 256^3),
//   examples/probe512.py copy_probe (:27, a sweep of tile heights TM),
//   examples/probe512split.py copy_call (:50) and the two-buffer call in
//   its main (:64, two pairs in one launch), the copy in
//   examples/probe_poisson512.py main (:110) and in
//   examples/profile512.py main (:57, TM 8 and 4);
// - copy_rolls, o = a * 1.0000001f + 1e-20f * (roll(a, 1, 1) +
//   roll(a, 1, 2)) on a (N0, N1, N2) field, `rows` planes per block: the
//   copy + two in-plane rolls of examples/profile512.py main (:288). The
//   rolls wrap (jnp.roll semantics, as pltpu.roll). The 1e-20 term lies
//   below an f32 ulp of the field, but the neighbour loads must be issued:
//   the arithmetic is written with __fmul_rn/__fadd_rn, which the
//   compiler may neither contract nor drop (the build has no
//   --use_fast_math);
// - poisson3d_variant, the stripped 3-D Poisson apply of
//   examples/probe_poisson512.py variant_call (:65), in three modes:
//   REBUILT, the 7-point apply with the in-plane neighbours of row 0 /
//   N1-1 and column 0 / N2-1 taken from the edge inputs le1/re1/le2/re2
//   (the reference's roll patches) and the axis-0 neighbours read in
//   place (wrapping where axis 0 is periodic); NOROLL, the same with the
//   in-plane neighbours read as the centre value (the edges stay);
//   NOCOMP, p * 1.0000001f. The probe splits the time of the kernel the
//   step runs into its parts, so each mode is an instance of that kernel,
//   poisson3d.cuh's template, with its body stripped (below).
//
// What bounds them on an H100: memory traffic. Each reads its input once
// and writes its output once (the neighbour reads of copy_rolls and
// REBUILT come from L1/L2), 8 bytes per f32 cell against 1 to 22 flops:
// at 512x256x256 a field is 134 MB, so a copy, and a variant, moves 268 MB
// (>= 80 us at 3.35 TB/s).
//
// What the design does about it: copy_scale views its field as R rows
// (the leading axis) of C elements; a block covers `rows` rows by
// threads * VEC columns, with 16-byte (float4) accesses where the row
// length and the addresses allow (VEC 4), else 4-byte ones. `rows` is the
// card's counterpart of the TPU's tile height: it trades the number of
// blocks against the work of each. Inside its rows a block has `groups`
// rows of threads (blockDim.y), which take the rows in turn, each thread
// with U rows of loads in flight before their stores; the loads and
// stores are cache-streaming (__ldcs/__stcs: every byte is touched once,
// and the fields the path copies are larger than the 50 MB L2). The
// geometry comes from the host (fluca_tpu_torch.ops.probes.copy_scale_plan):
// 32 threads x 32 groups where `rows` is large (the 2-D tiles of 128-256
// rows), so that each thread has at most a few rows and the card a
// million threads; 64 x 4 for the 3-D tiles of 8-16 rows. The first
// design (256 threads per block, each walking `rows` rows 4 at a time)
// had 128 blocks, one per SM, and ~16 KB of loads in flight per SM at
// 4096^2 with 128 rows, and lost to torch.mul by 12 % there.
// copy_rolls takes one element per thread and `rows` planes per block,
// so its two neighbour loads hit lines the block's warps read anyway.
//
// poisson3d_variant. What held the first design back: it kept poisson3d's
// first geometry (one thread per cell, blockIdx.z the plane, 32x8 blocks,
// branchy neighbour reads) after poisson3d itself became a march, so it
// took apart a kernel that no step runs: on the H100 its NOCOMP (0.121 ms
// at 512x256x256) was slower than copy_scale (0.090 ms) and its REBUILT
// (0.210 ms) slower than the apply it stood for (0.155 ms). What the
// design does: each mode is poisson3d.cuh's kernel on its unsharded path
// (a block marches `run` planes of a (rows x 32) tile of the (j, k) plane
// with planes i-1, i, i+1 in a register ring, axis 0's coefficients
// staged per plane in shared memory, the in-plane ones in registers, one
// plane per trip), launched with the grid, block and run that
// poisson3d_launch_plan picks for the apply at the shape. The in-plane
// axes are walls: the apply's own resolve-once reads, whose zeros past a
// wall the edges replace. The blocks at the in-plane walls stage their
// run's edge values in shared memory beside the coefficients, before the
// block's one barrier, and the threads of an edge row or column take them
// from there per plane. REBUILT is the apply's arithmetic
// (poisson3d_axis, poisson3d_sp), so with true edges (the wrapped planes,
// or zeros at a wall) it equals the poisson3d apply bit for bit. NOROLL
// loads no in-plane neighbour of p. NOCOMP stores p * 1.0000001f of the
// ring's centre plane: the same blocks, march and index arithmetic, no
// neighbour load. "The same DMAs, no math" cannot be had on this card:
// the compiler drops loads whose values are unused. Two other ways to
// the edges ran slower on the H100: as the edge planes of the halo path
// (a pointer and a step per neighbour, the loop unrolled), and read per
// plane from the edge arrays in a branch; each took half again the
// staged version's registers. REBUILT differs from the apply only in its
// edges, so their cost is the time between the two.
#include "poisson3d.cuh"

namespace {

constexpr float kScale = 1.0000001f;
constexpr float kTiny = 1e-20f;
constexpr int kCopyThreads = 256;     // copy_rolls' block
constexpr int kCopyMaxThreads = 1024;

__device__ __forceinline__ float scaled(float x) { return __fmul_rn(x, kScale); }

__device__ __forceinline__ float4 scaled(float4 x) {
    return make_float4(scaled(x.x), scaled(x.y), scaled(x.z), scaled(x.w));
}

template <int VEC>
struct VecOf;
template <>
struct VecOf<1> {
    using type = float;
};
template <>
struct VecOf<4> {
    using type = float4;
};

// blockIdx.z picks the pair; R rows of C floats, C a multiple of VEC.
// Block (x, y) covers rows y*rows .. and columns x*blockDim.x ..; thread
// row g of blockDim.y takes the block's rows g, g + blockDim.y, ...,
// U of them per pass (the loads predicated, then the stores).
template <int VEC, int U>
__global__ void __launch_bounds__(kCopyMaxThreads)
copy_scale_kernel(const float* __restrict__ a0, float* __restrict__ o0,
                  const float* __restrict__ a1, float* __restrict__ o1,
                  long long R, long long C, int rows) {
    using V = typename VecOf<VEC>::type;
    const V* __restrict__ a = reinterpret_cast<const V*>(blockIdx.z ? a1 : a0);
    V* __restrict__ o = reinterpret_cast<V*>(blockIdx.z ? o1 : o0);
    const long long cv = C / VEC;
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= cv) return;
    const long long r0 = (long long)blockIdx.y * rows;
    const long long r1 = min(r0 + rows, R);
    const int step = blockDim.y;
    for (long long r = r0 + threadIdx.y; r < r1; r += (long long)U * step) {
        V v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (r + u * step < r1) v[u] = __ldcs(a + (r + u * step) * cv + c);
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (r + u * step < r1) __stcs(o + (r + u * step) * cv + c, scaled(v[u]));
    }
}

// One thread per element e = j * N2 + k of a plane, `rows` planes per
// block along blockIdx.y.
__global__ void __launch_bounds__(kCopyThreads)
copy_rolls_kernel(const float* __restrict__ a, float* __restrict__ o, int N0,
                  int N1, int N2, int rows) {
    const long long plane = (long long)N1 * N2;
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= plane) return;
    const int j = (int)(e / N2);
    const int k = (int)(e - (long long)j * N2);
    // roll(a, 1, axis): out[q] = a[q - 1], wrapping
    const long long e1 = j == 0 ? e + (long long)(N1 - 1) * N2 : e - N2;
    const long long e2 = k == 0 ? e + (N2 - 1) : e - 1;
    const int i0 = blockIdx.y * rows;
    const int i1 = min(i0 + rows, N0);
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
        const long long base = i * plane;
        const float x = __ldg(a + base + e);
        const float r = __fadd_rn(__ldg(a + base + e1), __ldg(a + base + e2));
        o[base + e] = __fadd_rn(scaled(x), __fmul_rn(kTiny, r));
    }
}

}  // namespace

// a0 o0 [a1 o1]: npairs (1 or 2) pairs of R x C floats; vec 4 takes
// float4 accesses (C % 4 == 0, 16-byte aligned addresses), vec 1 floats.
// threads x groups: the block, unroll 2 or 4 (copy_scale_plan).
extern "C" int fluca_copy_scale_f32(const void* a0, void* o0, const void* a1,
                                    void* o1, long long R, long long C,
                                    int rows, int npairs, int vec, int threads,
                                    int groups, int unroll, void* stream) {
    if (R <= 0 || C <= 0 || rows <= 0 || npairs < 1 || npairs > 2 ||
        (vec != 1 && vec != 4) || C % vec || threads <= 0 || threads % 32 ||
        groups <= 0 || threads * groups > kCopyMaxThreads ||
        (unroll != 2 && unroll != 4))
        return (int)cudaErrorInvalidValue;
    const long long gx = (C / vec + threads - 1) / threads;
    const long long gy = (R + rows - 1) / rows;
    if (gx > 0x7fffffffLL || gy > fluca::kMaxGridYZ)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)gx, (unsigned)gy, npairs), block(threads, groups);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* A0 = static_cast<const float*>(a0);
    const float* A1 = static_cast<const float*>(npairs == 2 ? a1 : a0);
    float* O0 = static_cast<float*>(o0);
    float* O1 = static_cast<float*>(npairs == 2 ? o1 : o0);
#define FLUCA_COPY(VEC, U) \
    copy_scale_kernel<VEC, U><<<grid, block, 0, s>>>(A0, O0, A1, O1, R, C, rows)
    if (vec == 4) {
        if (unroll == 2) FLUCA_COPY(4, 2);
        else FLUCA_COPY(4, 4);
    } else {
        if (unroll == 2) FLUCA_COPY(1, 2);
        else FLUCA_COPY(1, 4);
    }
#undef FLUCA_COPY
    return (int)cudaGetLastError();
}

extern "C" int fluca_copy_rolls_f32(const void* a, void* o, int N0, int N1,
                                    int N2, int rows, void* stream) {
    if (N0 <= 0 || N1 <= 0 || N2 <= 0 || rows <= 0)
        return (int)cudaErrorInvalidValue;
    const long long gx = ((long long)N1 * N2 + kCopyThreads - 1) / kCopyThreads;
    const long long gy = (N0 + (long long)rows - 1) / rows;
    if (gx > 0x7fffffffLL || gy > fluca::kMaxGridYZ)
        return (int)cudaErrorInvalidConfiguration;
    copy_rolls_kernel<<<dim3((unsigned)gx, (unsigned)gy), kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<float*>(o), N0, N1, N2, rows);
    return (int)cudaGetLastError();
}

// ptrs: p a0 c1 c2 h0 h1 h2 le1 re1 le2 re2 out; mode: 0 REBUILT, 1
// NOROLL, 2 NOCOMP (poisson3d.cuh's Strip); plan: the apply's at this
// shape (fluca_tpu_torch.ops.cuda_stencil.poisson3d_launch_plan), checked
// against it by launch.
extern "C" int fluca_poisson3d_variant_f32(int mode, const void* const* ptrs, int N0, int N1,
                                           int N2, int per0, const int* plan, void* stream) {
    Args<float> h = {};
    h.p.x = static_cast<const float*>(ptrs[0]);
    for (int a = 0; a < 3; ++a) {
        h.band[a] = static_cast<const float*>(ptrs[1 + a]);
        h.h[a] = static_cast<const float*>(ptrs[4 + a]);
    }
    // the edges, as the edge planes of axes 1 and 2 (le1/re1 (N0, 1, N2),
    // le2/re2 (N0, N1, 1)); the in-plane axes are walls, whose zero reads
    // the staged edges replace
    for (int a = 1; a < 3; ++a) {
        h.p.lo[a] = static_cast<const float*>(ptrs[5 + 2 * a]);
        h.p.hi[a] = static_cast<const float*>(ptrs[6 + 2 * a]);
    }
    h.out = static_cast<float*>(const_cast<void*>(ptrs[11]));
    fluca::HaloGeom<3>& g = h.g;
    const int N[3] = {N0, N1, N2};
    for (int a = 0; a < 3; ++a) g.n[a] = g.ng[a] = N[a];
    g.mode[0] = per0 ? fluca::kPeriodic : fluca::kWall;
    g.mode[1] = g.mode[2] = fluca::kWall;
    g.st[0] = (long long)N1 * N2;
    g.st[1] = N2;
    g.st[2] = 1;
    g.est[1][0] = N2;  // le1[i, 0, k] at i * N2 + k
    g.est[2][0] = N1;  // le2[i, j, 0] at i * N1 + j
    switch (mode) {
        case kRebuilt:
            return launch<float, false, kRebuilt>(0, h, plan, stream);
        case kNoRoll:
            return launch<float, false, kNoRoll>(0, h, plan, stream);
        case kNoComp:
            return launch<float, false, kNoComp>(0, h, plan, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
