// Shared helpers for the stencil kernels of fluca_tpu_torch.
//
// Neighbour reads follow fluca_tpu_torch.ops.banded.shifted: a read
// outside a non-periodic axis is 0, a read outside a periodic axis
// wraps around the whole (global) axis.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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
};

template <typename T>
using acc_t = typename Field<T>::acc;

__device__ __forceinline__ int wrap_index(int k, int n) {
    k %= n;
    return k < 0 ? k + n : k;
}

// Brings k into [0, n) on a periodic axis; false when k lies outside
// a non-periodic one (the read is then 0).
__device__ __forceinline__ bool in_axis(int& k, int n, int per) {
    if (k >= 0 && k < n) return true;
    if (!per) return false;
    k = wrap_index(k, n);
    return true;
}

// Neighbour reads of a field, in the type the kernel computes in.
template <typename T>
__device__ __forceinline__ acc_t<T> load2d(const T* __restrict__ x, int i,
                                           int j, int N0, int N1, int per0,
                                           int per1) {
    if (!in_axis(i, N0, per0) || !in_axis(j, N1, per1)) return acc_t<T>(0);
    return Field<T>::load(x + (size_t)i * N1 + j);
}

template <typename T>
__device__ __forceinline__ acc_t<T> load3d(const T* __restrict__ x, int i,
                                           int j, int k, int N0, int N1,
                                           int N2, int per0, int per1,
                                           int per2) {
    if (!in_axis(i, N0, per0) || !in_axis(j, N1, per1) ||
        !in_axis(k, N2, per2))
        return acc_t<T>(0);
    return Field<T>::load(x + ((size_t)i * N1 + j) * N2 + k);
}

// One thread per cell, the contiguous axis along threadIdx.x so a
// warp reads 32 neighbouring addresses. In 3-D the block covers a
// kBlockY x kBlockX patch of one (j, k) plane and blockIdx.z is the
// plane index i.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxGridYZ = 65535;

inline dim3 grid2d(int N0, int N1) {
    return dim3((N1 + kBlockX - 1) / kBlockX, (N0 + kBlockY - 1) / kBlockY);
}

inline dim3 grid3d(int N0, int N1, int N2) {
    return dim3((N2 + kBlockX - 1) / kBlockX, (N1 + kBlockY - 1) / kBlockY,
                N0);
}

}  // namespace fluca
