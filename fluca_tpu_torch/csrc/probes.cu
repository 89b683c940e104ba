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
//   in-plane neighbours read as the centre value before the edge
//   replacement; NOCOMP, p * 1.0000001f. REBUILT shares csrc/poisson3d.cu's
//   arithmetic (stencil_common.cuh poisson3d_axis, poisson3d_sp), so with
//   true edges it equals the poisson3d apply. On this card "the same
//   DMAs, no math" cannot be had: the compiler drops loads whose values
//   are unused. So NOCOMP is the copy through the variant's launch
//   geometry (the first poisson3d design's grid and 32x8 blocks, one
//   thread per cell and plane, its index arithmetic), and NOROLL reads no
//   in-plane neighbour of p.
//
// What bounds them on an H100: memory traffic. Each reads its input once
// and writes its output once (the neighbour reads of copy_rolls and
// REBUILT come from L1/L2), 8 bytes per f32 cell against 1 to 22 flops:
// at 512x256x256 a field is 134 MB, so a copy moves 268 MB (>= 80 us at
// 3.35 TB/s).
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
#include "stencil_common.cuh"

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

enum VariantMode : int { kRebuilt = 0, kNoRoll = 1, kNoComp = 2 };

// le1/re1: (N0, N2) planes for rows 0 / N1-1; le2/re2: (N0, N1) for
// columns 0 / N2-1 (the reference's (N0, 1, N2) and (N0, N1, 1) arrays).
template <int MODE>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
poisson3d_variant_kernel(const float* __restrict__ p,
                         const float* __restrict__ a0,
                         const float* __restrict__ c1,
                         const float* __restrict__ c2,
                         const float* __restrict__ h0,
                         const float* __restrict__ h1,
                         const float* __restrict__ h2,
                         const float* __restrict__ le1,
                         const float* __restrict__ re1,
                         const float* __restrict__ le2,
                         const float* __restrict__ re2, float* __restrict__ out,
                         int N0, int N1, int N2, int per0) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int i = blockIdx.z;
    if (j >= N1 || k >= N2) return;
    const size_t idx = ((size_t)i * N1 + j) * N2 + k;
    const float pc = __ldg(p + idx);
    if (MODE == kNoComp) {
        out[idx] = scaled(pc);
        return;
    }
    const float up = fluca::load3d(p, i - 1, j, k, N0, N1, N2, per0, 0, 0);
    const float dn = fluca::load3d(p, i + 1, j, k, N0, N1, N2, per0, 0, 0);
    const size_t row = (size_t)i * N2 + k;  // le1/re1
    const size_t col = (size_t)i * N1 + j;  // le2/re2
    float left, right, fwd, bwd;
    if (MODE == kRebuilt) {
        left = j == 0 ? __ldg(le1 + row) : __ldg(p + idx - N2);
        right = j == N1 - 1 ? __ldg(re1 + row) : __ldg(p + idx + N2);
        fwd = k == 0 ? __ldg(le2 + col) : __ldg(p + idx - 1);
        bwd = k == N2 - 1 ? __ldg(re2 + col) : __ldg(p + idx + 1);
    } else {
        left = j == 0 ? __ldg(le1 + row) : pc;
        right = j == N1 - 1 ? __ldg(re1 + row) : pc;
        fwd = k == 0 ? __ldg(le2 + col) : pc;
        bwd = k == N2 - 1 ? __ldg(re2 + col) : pc;
    }
    const float s0 = fluca::poisson3d_axis(__ldg(a0 + i), __ldg(a0 + N0 + i),
                                           __ldg(a0 + 2 * N0 + i), up, pc, dn);
    const float s1 = fluca::poisson3d_axis(__ldg(c1 + j), __ldg(c1 + N1 + j),
                                           __ldg(c1 + 2 * N1 + j), left, pc, right);
    const float s2 = fluca::poisson3d_axis(__ldg(c2 + k), __ldg(c2 + N2 + k),
                                           __ldg(c2 + 2 * N2 + k), fwd, pc, bwd);
    out[idx] = fluca::poisson3d_sp(s0, s1, s2, __ldg(h0 + i), __ldg(h1 + j),
                                   __ldg(h2 + k));
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

// ptrs: p a0 c1 c2 h0 h1 h2 le1 re1 le2 re2 out
extern "C" int fluca_poisson3d_variant_f32(int mode, const void* const* ptrs,
                                           int N0, int N1, int N2, int per0,
                                           void* stream) {
    const float* f[11];
    for (int m = 0; m < 11; ++m) f[m] = static_cast<const float*>(ptrs[m]);
    float* O = static_cast<float*>(const_cast<void*>(ptrs[11]));
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid3d(N0, N1, N2);
    if (grid.y > fluca::kMaxGridYZ || grid.z > fluca::kMaxGridYZ)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLUCA_VARIANT_ARGS                                                    \
    f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], O, N0, \
        N1, N2, per0
    switch (mode) {
        case kRebuilt:
            poisson3d_variant_kernel<kRebuilt><<<grid, block, 0, s>>>(FLUCA_VARIANT_ARGS);
            break;
        case kNoRoll:
            poisson3d_variant_kernel<kNoRoll><<<grid, block, 0, s>>>(FLUCA_VARIANT_ARGS);
            break;
        case kNoComp:
            poisson3d_variant_kernel<kNoComp><<<grid, block, 0, s>>>(FLUCA_VARIANT_ARGS);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef FLUCA_VARIANT_ARGS
    return (int)cudaGetLastError();
}
