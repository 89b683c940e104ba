// Shared helpers for the stencil kernels of fluca_tpu_torch.
//
// Neighbour reads follow fluca_tpu_torch.ops.banded.shifted: a read
// outside a non-periodic axis is 0, a read outside a periodic axis
// wraps around the whole (global) axis.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace fluca {

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

template <typename T>
__device__ __forceinline__ T load2d(const T* __restrict__ x, int i, int j,
                                    int N0, int N1, int per0, int per1) {
    if (!in_axis(i, N0, per0) || !in_axis(j, N1, per1)) return T(0);
    return __ldg(x + (size_t)i * N1 + j);
}

template <typename T>
__device__ __forceinline__ T load3d(const T* __restrict__ x, int i, int j,
                                    int k, int N0, int N1, int N2, int per0,
                                    int per1, int per2) {
    if (!in_axis(i, N0, per0) || !in_axis(j, N1, per1) ||
        !in_axis(k, N2, per2))
        return T(0);
    return __ldg(x + ((size_t)i * N1 + j) * N2 + k);
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
