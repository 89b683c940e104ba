// Shared helpers for the stencil kernels of fluca_tpu_torch.
//
// Neighbour reads follow fluca_tpu_torch.ops.banded.shifted: a read
// outside a non-periodic axis is 0, a read outside a periodic axis
// wraps around the whole (global) axis.
//
// Who uses what:
// - Field<T>::load/store/up/down, acc_t: every kernel;
// - Pack<T, VEC> (VEC cells read or written as one access) and Lane2D /
//   Rows2D (the lanes, columns and rows of a 2-D march): poisson2d.cu and
//   momentum2d.cu;
// - poisson3d_axis/poisson3d_sp: poisson3d.cuh (poisson3d.cu and
//   probes.cu);
// - plane_coeffs (4 staged values of a row or plane): poisson2d.cu and
//   poisson3d.cuh;
// - kMaxGridYZ: probes.cu's copies;
// - HaloGeom, HaloField: the *_halo kernels and probes.cu's
//   poisson3d_variant; halo_load: momentum3d.cu's +-2 reads (wall rows
//   only);
// - Where/Nb/resolve (an in-plane neighbour's wrap, zero or edge plane
//   resolved once per thread, not per load): momentum3d.cu and
//   poisson3d.cuh;
// - mad (a fused multiply-add whatever the context): every kernel but
//   probes.cu's copies and poisson2d.cu, in their f32 and f64 instances;
//   mul, add, sub (one rounding each, never contracted): poisson2d.cu, and
//   the bf16 instances of poisson3d.cuh and momentum3d.cu (kPlainOrder;
//   madd, mult, plus choose between the two by the field type).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

namespace fluca {

// The field (storage) type T of a kernel instance and the type it
// computes in, Field<T>::acc. The f32 and f64 instances compute in
// their own type. The bf16 instance (the reduced-precision ABF
// preconditioner's, fluca_tpu/ops/pallas_stencil.py _coef_dtype) reads
// bf16 fields, takes its coefficient arrays as float, accumulates in
// float and rounds once, at the store.
template <typename T>
struct Field {
    using acc = T;
    static __device__ __forceinline__ T load(const T* __restrict__ x) {
        return __ldg(x);
    }
    static __device__ __forceinline__ void store(T* x, T v) { *x = v; }
    static __device__ __forceinline__ T up(T x) { return x; }
    static __device__ __forceinline__ T down(T x) { return x; }
};

template <>
struct Field<__nv_bfloat16> {
    using acc = float;
    static __device__ __forceinline__ float load(
        const __nv_bfloat16* __restrict__ x) {
        return __bfloat162float(__ushort_as_bfloat16(
            __ldg(reinterpret_cast<const unsigned short*>(x))));
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* x, float v) {
        *x = __float2bfloat16_rn(v);
    }
    static __device__ __forceinline__ float up(__nv_bfloat16 x) {
        return __bfloat162float(x);
    }
    static __device__ __forceinline__ __nv_bfloat16 down(float x) {
        return __float2bfloat16_rn(x);
    }
};

template <typename T>
using acc_t = typename Field<T>::acc;

// a * b + c rounded once, whatever the context it is inlined into, so
// that two kernels that call one arithmetic function round alike.
__device__ __forceinline__ float mad(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
    return __fma_rn(a, b, c);
}

// A product, sum or difference rounded on its own, which the compiler may
// not contract into a fused multiply-add: the arithmetic of a plain
// PyTorch version, where every operation is one rounded kernel
// (poisson2d.cu).
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// Whether the instance for fields of type T rounds every product, sum and
// difference on its own, in its plain version's order (mul, add, sub), in
// place of fused multiply-adds: the bf16 instances, whose plain versions
// (fluca_tpu_torch/ops/cuda_stencil.py) compute in float32 one rounded
// torch operation at a time. Where terms cancel, a fused sum parts from
// such a version by a bf16 unit at some cells. The f32 and f64 instances
// keep their fused sums, so that they, and the halo instances that share
// their arithmetic, stay equal to their first designs bit for bit.
template <typename T>
constexpr bool kPlainOrder = false;
template <>
constexpr bool kPlainOrder<__nv_bfloat16> = true;

// a * b + c, a * b and a + b in the arithmetic of fields of type T: each
// product and sum rounded on its own where kPlainOrder<T>, else a fused
// multiply-add and the plain operators (momentum3d.cu).
template <typename T, typename C>
__device__ __forceinline__ C madd(C a, C b, C c) {
    if constexpr (kPlainOrder<T>)
        return add(mul(a, b), c);
    else
        return mad(a, b, c);
}
template <typename T, typename C>
__device__ __forceinline__ C mult(C a, C b) {
    if constexpr (kPlainOrder<T>)
        return mul(a, b);
    else
        return a * b;
}
template <typename T, typename C>
__device__ __forceinline__ C plus(C a, C b) {
    if constexpr (kPlainOrder<T>)
        return add(a, b);
    else
        return a + b;
}

__device__ __forceinline__ int wrap_index(int k, int n) {
    k %= n;
    return k < 0 ? k + n : k;
}

// The arithmetic of the 3-D Poisson apply, shared by the instances of
// csrc/poisson3d.cuh's kernel (poisson3d.cu's unsharded and halo ones,
// probes.cu's variants), so that they round alike whatever the code
// around them: one axis' sum bm xm + bc xc + bp xp of the three band
// values at an index, and Sp = H1[j] H2[k] s0 + H0[i] (H2[k] s1 + H1[j] s2).
// For fields of type T with kPlainOrder<T> (bf16) every product and sum
// is rounded on its own in the plain version's order, (bm xm + bc xc) +
// bp xp and (hj hk) s0 + h0 (hk s1 + hj s2). Otherwise each is a chain of
// explicit fused multiply-adds in the order nvcc chose for the first
// design's expressions (b0 xm + b1 xc + b2 xp and hj hk s0 + h0 (hk s1 +
// hj s2), contracted), so the redesigned kernel equals it bit for bit,
// and the step its results.
template <typename T, typename C>
__device__ __forceinline__ C poisson3d_axis(C bm, C bc, C bp, C xm, C xc, C xp) {
    if constexpr (kPlainOrder<T>)
        return add(add(mul(bm, xm), mul(bc, xc)), mul(bp, xp));
    else
        return mad(bp, xp, mad(bm, xm, bc * xc));
}

template <typename T, typename C>
__device__ __forceinline__ C poisson3d_sp(C s0, C s1, C s2, C h0, C hj, C hk) {
    if constexpr (kPlainOrder<T>)
        return add(mul(mul(hj, hk), s0), mul(h0, add(mul(hk, s1), mul(hj, s2))));
    else
        return mad(hj * hk, s0, h0 * mad(hj, s2, hk * s1));
}

// The CUDA grid's y and z extents.
constexpr int kMaxGridYZ = 65535;

// ---------------------------------------------------------------------
// Halo instances: one shard's block of a domain-decomposed grid
// (fluca_tpu_torch/parallel/sharded.py).
//
// A halo kernel computes the stencil on one block (a box of extents n)
// of tensors that may hold more than the block: it takes a pointer to
// the block's first element and the tensors' element strides, reads its
// box in place and writes the box of the output. Shards that share one
// device are boxes of the global tensors, so a call copies nothing but
// the edge planes; a shard on a device of its own passes a contiguous
// block at offset 0.
//
// Each axis has a mode. On a wall axis a read past the block is 0; on a
// periodic axis it wraps around the block (such an axis is not split,
// so the block is the whole axis); on a halo axis a read at local index
// -1 or n comes from the edge plane handed in for that side (the plane
// of the neighbour shard, of the other end of a periodic axis, or zeros
// at a wall), and any read further out is 0. A halo axis never wraps
// inside the block: the wrap arrives through the edge planes. The
// neighbours of a cell are read along one axis at a time, as every
// stencil here reads them.
enum AxisMode : int { kWall = 0, kPeriodic = 1, kHalo = 2 };

template <int D>
struct HaloGeom {
    int n[D];             // the block's extents
    int ng[D];            // the global extents: the row length of the
                          // coefficient arrays, which are per global index
    int mode[D];          // AxisMode
    long long st[D];      // element strides of the cell tensors
    long long est[D][D];  // est[a][b]: element strides along b of the
                          // edge planes of axis a
};

// The geometry from the host's array: n, ng, mode, st (D each), est
// (D x D, row-major); returns the number of entries read.
template <int D>
inline int read_halo_geom(const long long* a, HaloGeom<D>& g) {
    int m = 0;
    for (int d = 0; d < D; ++d) g.n[d] = (int)a[m++];
    for (int d = 0; d < D; ++d) g.ng[d] = (int)a[m++];
    for (int d = 0; d < D; ++d) g.mode[d] = (int)a[m++];
    for (int d = 0; d < D; ++d) g.st[d] = a[m++];
    for (int d = 0; d < D; ++d)
        for (int e = 0; e < D; ++e) g.est[d][e] = a[m++];
    return m;
}

// A field of a halo kernel: the block's first element, and per axis
// the element of each edge plane at the block's origin (null on an
// axis that is not a halo axis).
template <typename T, int D>
struct HaloField {
    const T* x;
    const T* lo[D];
    const T* hi[D];
};

// The field at pos moved by off along ax, in the type the kernel
// computes in.
template <typename T, int D>
__device__ __forceinline__ acc_t<T> halo_load(const HaloField<T, D>& f,
                                              const HaloGeom<D>& g,
                                              const int (&pos)[D], int ax,
                                              int off) {
    int q = pos[ax] + off;
    const int n = g.n[ax];
    if (q < 0 || q >= n) {
        if (g.mode[ax] == kPeriodic) {
            q = wrap_index(q, n);
        } else {
            if (g.mode[ax] != kHalo || (q != -1 && q != n)) return acc_t<T>(0);
            long long o = 0;
#pragma unroll
            for (int b = 0; b < D; ++b)
                if (b != ax) o += pos[b] * g.est[ax][b];
            return Field<T>::load((q < 0 ? f.lo[ax] : f.hi[ax]) + o);
        }
    }
    long long o = 0;
#pragma unroll
    for (int b = 0; b < D; ++b) o += (b == ax ? q : pos[b]) * g.st[b];
    return Field<T>::load(f.x + o);
}

// Where an in-plane read lands, resolved once per thread: in the block
// (off: its offset in the plane), zero (off: the thread's own cell, a
// valid address whose value is then dropped), or on the lo/hi edge
// plane of a halo axis (off: its offset in that plane, at plane 0).
enum Where : int { kIn = 0, kZero = 1, kLo = 2, kHi = 3 };
struct Nb {
    int where;
    long long off;
};

// The read at index q along in-plane axis AX (1 or 2) of the thread at
// (j, k) of a block with cell strides g.st (g.st[2] == 1); q is one past
// the block at most.
template <int AX>
__device__ __forceinline__ Nb resolve(const HaloGeom<3>& g, int j, int k, int q) {
    const int n = g.n[AX];
    if (q < 0 || q >= n) {
        if (g.mode[AX] == kPeriodic) {
            q += q < 0 ? n : -n;
        } else if (g.mode[AX] == kHalo) {
            return {q < 0 ? kLo : kHi, AX == 1 ? k * g.est[1][2] : j * g.est[2][1]};
        } else {
            return {kZero, j * g.st[1] + k};
        }
    }
    return AX == 1 ? Nb{kIn, q * g.st[1] + k} : Nb{kIn, j * g.st[1] + q};
}

// ---------------------------------------------------------------------
// Marching kernels: a block walks `run` rows (2-D) or planes (3-D) along
// axis 0 and stages axis 0's coefficients per row in shared memory.

// The 4 staged values of a row or plane: one 16-byte shared-memory read
// for float, two for double.
__device__ __forceinline__ void plane_coeffs(const float* s, float (&a)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    a[0] = x.x;
    a[1] = x.y;
    a[2] = x.z;
    a[3] = x.w;
}
__device__ __forceinline__ void plane_coeffs(const double* s, double (&a)[4]) {
    const double2 x = *reinterpret_cast<const double2*>(s);
    const double2 y = *reinterpret_cast<const double2*>(s + 2);
    a[0] = x.x;
    a[1] = x.y;
    a[2] = y.x;
    a[3] = y.y;
}

template <int BYTES>
struct RawOf;
template <>
struct RawOf<2> {
    using type = unsigned short;
};
template <>
struct RawOf<4> {
    using type = unsigned int;
};
template <>
struct RawOf<8> {
    using type = uint2;
};
template <>
struct RawOf<16> {
    using type = uint4;
};

// VEC consecutive cells of a row, read or written as one access of
// VEC * sizeof(T) bytes (2 to 16; the address aligned to it), in the type
// the kernel computes in.
template <typename T, int VEC>
struct Pack {
    using C = acc_t<T>;
    using Raw = typename RawOf<sizeof(T) * VEC>::type;
    C v[VEC];

    static __device__ __forceinline__ Pack load(const T* x) {
        const Raw r = __ldg(reinterpret_cast<const Raw*>(x));
        T t[VEC];
        memcpy(t, &r, sizeof r);
        Pack out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) out.v[k] = Field<T>::up(t[k]);
        return out;
    }
    __device__ __forceinline__ void store(T* x) const {
        T t[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k] = Field<T>::down(v[k]);
        Raw r;
        memcpy(&r, t, sizeof r);
        *reinterpret_cast<Raw*>(x) = r;
    }
    // every cell 0 where z
    __device__ __forceinline__ void zero_if(bool z) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = z ? C(0) : v[k];
    }
};

// One lane of a 2-D march (poisson2d.cu, momentum2d.cu), whose stencil
// reaches H columns to each side. Warp w (blockIdx.x * blockDim.y +
// threadIdx.y) owns the kCols columns from c0 = w * kCols; lane t holds VEC
// cells of a row from column js = c0 + (t - kEnd) * VEC. The kEnd lanes
// at each end of the warp hold the columns up to H past the warp's own,
// which the other lanes take with shuffles; they compute nothing. Where a
// lane's field reads start is resolved once: in the block, wrapped on a
// periodic axis 1, or past a wall or halo axis 1, where its cells read 0
// but for the one at local column -1 or n1 of a halo axis, which reads the
// lo or hi edge column. n1 is a multiple of VEC.
template <int VEC, int H>
struct Lane2D {
    static constexpr int kEnd = (H + VEC - 1) / VEC;  // lanes at each end
    static constexpr int kCols = (32 - 2 * kEnd) * VEC;
    int c0;        // the warp's first column
    int js;        // the lane's first column (may lie outside the block)
    bool compute;  // the lane computes and stores its cells
    int col;       // the column its field reads start at (in the block)
    int own;       // the column its other reads start at: js where it
                   // computes, else a computing lane's (the same lines)
    bool zero;     // its field cells read 0
    int edge;      // its cell that reads an edge column (-1: none)
    bool hi;       // that edge column is the hi one

    __device__ __forceinline__ Lane2D(const HaloGeom<2>& g, int warp, int lane) {
        const int n1 = g.n[1];
        c0 = warp * kCols;
        js = c0 + (lane - kEnd) * VEC;
        compute = lane >= kEnd && lane < 32 - kEnd && js < n1;
        own = min(max(js, c0), min(c0 + kCols, n1) - VEC);
        col = js;
        zero = false;
        edge = -1;
        hi = false;
        if (js < 0 || js >= n1) {
            if (g.mode[1] == kPeriodic) {
                col = wrap_index(js, n1);
            } else {
                col = own;
                zero = true;
                if (g.mode[1] == kHalo && js < 0 && js + VEC > -1) edge = -1 - js;
                if (g.mode[1] == kHalo && js == n1) {
                    edge = 0;
                    hi = true;
                }
            }
        }
    }
};

// The rows of a field in a 2-D march along axis 0: row q (a few past
// either end at most) of a lane's column: in the block, wrapped on a
// periodic axis 0, on the lo or hi edge row of a halo axis 0 (q = -1 or
// n0; est: the edge rows' element stride along axis 1), or zero. Selects,
// not branches, so that a row's loads go out together.
template <typename T, bool HALO>
struct Rows2D {
    const T* x;
    const T* lo;
    const T* hi;
    long long st0, est;
    int n0, mode0;

    __device__ __forceinline__ const T* at(int q, int col, bool& zero) const {
        const bool in = q >= 0 && q < n0;
        const bool per = mode0 == kPeriodic;
        int qq = q < 0 ? q + n0 : q - n0;
        qq = in ? q : !per ? 0 : qq < 0 ? qq + n0 : qq >= n0 ? qq - n0 : qq;
        const T* ptr = x + qq * st0 + col;
        const bool edge = HALO && mode0 == kHalo && (q == -1 || q == n0);
        if (edge) ptr = (q < 0 ? lo : hi) + col * est;
        zero = !in && !per && !edge;
        return ptr;
    }
};

}  // namespace fluca
