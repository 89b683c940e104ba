// Fused 2-D pressure-Poisson stencil: apply, residual and damped-Jacobi
// smooth.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// poisson2d_raw_call (wrapped by _build_poisson_2d and
// build_poisson_{apply,residual,smooth}_2d). It computes
//
//   Sp[i,j] = CY[j] * sum_o RX[o,i] * p[i+o,j]
//           + RY[i] * sum_o CYb[o,j] * p[i,j+o]          (o in -1,0,1)
//
// and, by MODE, writes  Sp  |  b - Sp  |  p + omega * w * (b - Sp).
// Neighbours outside a non-periodic axis read 0 and wrap on a periodic
// one (fluca_tpu_torch.ops.banded.shifted), so no halo rows or columns
// are passed in. RX is (3,N0), RY (N0), CY (N1), CYb (3,N1), all in the
// field's dtype; p, b, w and out are (N0,N1), C-contiguous.
//
// What bounds it on an H100: memory traffic. Per cell it does about 10
// (apply) to 16 (smooth) flops against 8, 12 or 16 bytes of f32 field
// traffic, far below the card's flop:byte ratio. At the cavity's own
// sizes (256^2 and its coarser multigrid levels) one f32 field is at
// most 256 KB and the whole working set sits in the 50 MB L2, so a
// launch is bound by launch latency rather than by bandwidth.
//
// What the design does about it: one thread per cell reads each field
// once from device memory (the four neighbour reads of p hit L1/L2),
// warps run along the contiguous axis for coalesced loads, and the
// three modes are template instances so the residual and the smoother
// are one pass each instead of an apply plus an elementwise pass.
// Shared-memory tiling and batching several launches into one are
// later work.
#include "stencil_common.cuh"

namespace {

template <typename T, int MODE>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
poisson2d_kernel(const T* __restrict__ p, const T* __restrict__ b,
                 const T* __restrict__ w, const T* __restrict__ rx,
                 const T* __restrict__ ry, const T* __restrict__ cy,
                 const T* __restrict__ cyb, T* __restrict__ out, int N0,
                 int N1, int per0, int per1, T omega) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= N0 || j >= N1) return;
    const size_t idx = (size_t)i * N1 + j;

    const T pc = __ldg(p + idx);
    const T up = fluca::load2d(p, i - 1, j, N0, N1, per0, per1);
    const T dn = fluca::load2d(p, i + 1, j, N0, N1, per0, per1);
    const T lf = fluca::load2d(p, i, j - 1, N0, N1, per0, per1);
    const T rt = fluca::load2d(p, i, j + 1, N0, N1, per0, per1);

    const T xterm = (__ldg(rx + i) * up + __ldg(rx + N0 + i) * pc +
                     __ldg(rx + 2 * N0 + i) * dn) *
                    __ldg(cy + j);
    const T yterm = __ldg(ry + i) *
                    (__ldg(cyb + j) * lf + __ldg(cyb + N1 + j) * pc +
                     __ldg(cyb + 2 * N1 + j) * rt);
    const T sp = xterm + yterm;

    if (MODE == 0) {
        out[idx] = sp;
    } else if (MODE == 1) {
        out[idx] = __ldg(b + idx) - sp;
    } else {
        out[idx] = pc + omega * __ldg(w + idx) * (__ldg(b + idx) - sp);
    }
}

template <typename T>
int launch(int mode, const void* p, const void* b, const void* w,
           const void* rx, const void* ry, const void* cy, const void* cyb,
           void* out, int N0, int N1, int per0, int per1, double omega,
           void* stream) {
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid2d(N0, N1);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* P = static_cast<const T*>(p);
    const T* B = static_cast<const T*>(b);
    const T* W = static_cast<const T*>(w);
    const T* RX = static_cast<const T*>(rx);
    const T* RY = static_cast<const T*>(ry);
    const T* CY = static_cast<const T*>(cy);
    const T* CYB = static_cast<const T*>(cyb);
    T* O = static_cast<T*>(out);
    const T om = static_cast<T>(omega);
    switch (mode) {
        case 0:
            poisson2d_kernel<T, 0><<<grid, block, 0, s>>>(
                P, B, W, RX, RY, CY, CYB, O, N0, N1, per0, per1, om);
            break;
        case 1:
            poisson2d_kernel<T, 1><<<grid, block, 0, s>>>(
                P, B, W, RX, RY, CY, CYB, O, N0, N1, per0, per1, om);
            break;
        case 2:
            poisson2d_kernel<T, 2><<<grid, block, 0, s>>>(
                P, B, W, RX, RY, CY, CYB, O, N0, N1, per0, per1, om);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fluca_poisson2d_f32(int mode, const void* p, const void* b,
                                   const void* w, const void* rx,
                                   const void* ry, const void* cy,
                                   const void* cyb, void* out, int N0,
                                   int N1, int per0, int per1, double omega,
                                   void* stream) {
    return launch<float>(mode, p, b, w, rx, ry, cy, cyb, out, N0, N1, per0,
                         per1, omega, stream);
}

extern "C" int fluca_poisson2d_f64(int mode, const void* p, const void* b,
                                   const void* w, const void* rx,
                                   const void* ry, const void* cy,
                                   const void* cyb, void* out, int N0,
                                   int N1, int per0, int per1, double omega,
                                   void* stream) {
    return launch<double>(mode, p, b, w, rx, ry, cy, cyb, out, N0, N1, per0,
                          per1, omega, stream);
}
