// Shared helpers for the 2-D stencil kernels of fluca_tpu_torch.
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

template <typename T>
__device__ __forceinline__ T load2d(const T* __restrict__ x, int i, int j,
                                    int N0, int N1, int per0, int per1) {
    if (i < 0 || i >= N0) {
        if (!per0) return T(0);
        i = wrap_index(i, N0);
    }
    if (j < 0 || j >= N1) {
        if (!per1) return T(0);
        j = wrap_index(j, N1);
    }
    return __ldg(x + (size_t)i * N1 + j);
}

// One thread per cell, j (the contiguous axis) along threadIdx.x so a
// warp reads 32 neighbouring addresses.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

inline dim3 grid2d(int N0, int N1) {
    return dim3((N1 + kBlockX - 1) / kBlockX, (N0 + kBlockY - 1) / kBlockY);
}

}  // namespace fluca
