// Fused 3-D momentum A-apply: (v0, v1, v2) -> A v with
// A = I + dt C(U0, v0f) - (mu dt / 2 rho) L, all three components in
// one pass.
//
// Replaces the TPU kernel fluca_tpu/ops/pallas_stencil.py
// momentum3d_raw_calls (wrapped by build_momentum_apply_3d). As there,
// the coefficients are formed in the kernel from
//   - three per-axis band arrays B_a (27, N_a) in the row packing of
//     build_momentum_bands_3d: Laplacian rows L(c, off) = c*5 + off+2
//     (off -2..2, scaled by -mu dt / 2 rho) and convection rows
//     CV(var, lr, off) = 15 + var*6 + lr*3 + off+1 (var 0 tangential,
//     1 normal; lr 0 low face, 1 high face; scaled by dt);
//   - the 12 face arrays of the step, U0[a] and v0f[a][c], read where
//     they lie: the low factor of cell q along axis a is face q, the
//     high one face q+1 (face_shape: N+1 faces on a non-periodic axis;
//     N on a periodic one, where face N wraps to 0).
// For component c and each axis a (shifts along a):
//   nl_a = sum_o CV_a(1,0,o) v_a(q+o),  nr_a likewise with CV_a(1,1,o)
//   A v_c += sum_{o=-2..2} L_a(c,o) v_c(q+o)
//          + (Flv_a[c] + [c==a] FlU_a) nl_a + (Frv_a[c] + [c==a] FrU_a) nr_a
//          + [c!=a] (FlU_a sum_o CV_a(0,0,o) v_c(q+o)
//                    + FrU_a sum_o CV_a(0,1,o) v_c(q+o))
// Neighbours outside a non-periodic axis read 0 and wrap on a periodic
// one (fluca_tpu_torch.ops.banded.shifted), the same on all three axes
// and for the +-2 rows; the TPU kernel's in-tile rolls, edge planes,
// P2/M2 planes and roll patches are not needed.
//
// Instances: f32 and f64 (everything in one type), and bf16 (the
// reduced-precision ABF preconditioner's): bf16 v, face arrays and
// outputs, float bands and arithmetic, one rounding at the store. The
// step builds the bf16 face arrays from its own U0 and v0f (a cast; the
// kernel reads the faces in place, so no tile layout is involved).
//
// What bounds it on an H100: memory traffic. Per cell it reads 3 v
// and 12 face factors (the high factor is the next cell's low one, so
// each face array streams once) and writes 3 outputs: 18 streams, as
// in the TPU kernel's cost estimate, for ~200 flops, below the card's
// flop:byte ratio. At 512x256x256 f32 that is 18 x 134 MB = 2.4 GB,
// >= 0.72 ms at 3.35 TB/s (half that in bf16).
//
// What the design does about it: one thread per cell computes all
// three components, so each v neighbour and each factor is loaded
// once for the three outputs; the TPU's per-component split existed
// only to fit its 16 MB VMEM and would re-read v and the factors here.
// Blocks of 32x8 cells run along the contiguous axis for coalesced
// loads; blockIdx.z walks the planes, so the +-1 plane reads hit L2.
// The band arrays (27 x N per axis) are a few tens of KB and stay
// cached. The +-2 Laplacian reads are made only where their band entry
// is nonzero (the boundary rows).
#include "stencil_common.cuh"

namespace {

constexpr int kBandRows = 27;

__host__ __device__ constexpr int lap_row(int c, int off) {
    return c * 5 + off + 2;
}

__host__ __device__ constexpr int conv_row(int var, int lr, int off) {
    return 15 + var * 6 + lr * 3 + off + 1;
}

template <typename T>
struct Args {
    const fluca::acc_t<T>* band[3];  // (27, N_a), in the compute type
    const T* v[3];                   // cell fields
    const T* fu[3];                  // U0[a], face_shape(a)
    const T* fv[9];                  // v0f[a][c] at 3*a + c, face_shape(a)
    T* out[3];
    int n[3];
    int per[3];
};

template <typename T>
__global__ void __launch_bounds__(fluca::kBlockX * fluca::kBlockY)
momentum3d_kernel(const Args<T> g) {
    using F = fluca::Field<T>;
    using C = fluca::acc_t<T>;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int i = blockIdx.z;
    const int N0 = g.n[0], N1 = g.n[1], N2 = g.n[2];
    if (j >= N1 || k >= N2) return;
    const int pos[3] = {i, j, k};
    const size_t idx = ((size_t)i * N1 + j) * N2 + k;

    C vc[3], acc[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
        vc[e] = F::load(g.v[e] + idx);
        acc[e] = vc[e];
    }

#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const int n = g.n[ax];
        const C* B = g.band[ax] + pos[ax];
        auto band = [&](int r) { return __ldg(B + (size_t)r * n); };
        auto at = [&](int e, int off) {
            int q[3] = {i, j, k};
            q[ax] += off;
            return fluca::load3d(g.v[e], q[0], q[1], q[2], N0, N1, N2,
                                 g.per[0], g.per[1], g.per[2]);
        };

        // low / high face of this cell along ax
        const int nf = g.per[ax] ? n : n + 1;
        int d[3] = {N0, N1, N2};
        d[ax] = nf;
        int q[3] = {i, j, k};
        const size_t lo = ((size_t)q[0] * d[1] + q[1]) * d[2] + q[2];
        q[ax] = pos[ax] + 1 == nf ? 0 : pos[ax] + 1;
        const size_t hi = ((size_t)q[0] * d[1] + q[1]) * d[2] + q[2];
        const C FlU = F::load(g.fu[ax] + lo);
        const C FrU = F::load(g.fu[ax] + hi);

        C vm[3], vp[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            vm[e] = at(e, -1);
            vp[e] = at(e, 1);
        }
        // normal-variant sums on v_ax, shared by the three components
        const C nl = band(conv_row(1, 0, -1)) * vm[ax] +
                     band(conv_row(1, 0, 0)) * vc[ax] +
                     band(conv_row(1, 0, 1)) * vp[ax];
        const C nr = band(conv_row(1, 1, -1)) * vm[ax] +
                     band(conv_row(1, 1, 0)) * vc[ax] +
                     band(conv_row(1, 1, 1)) * vp[ax];

#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const C Flv = F::load(g.fv[3 * ax + c] + lo);
            const C Frv = F::load(g.fv[3 * ax + c] + hi);
            C s = band(lap_row(c, -1)) * vm[c] + band(lap_row(c, 0)) * vc[c] +
                  band(lap_row(c, 1)) * vp[c];
            const C wm2 = band(lap_row(c, -2));
            if (wm2 != C(0)) s += wm2 * at(c, -2);
            const C wp2 = band(lap_row(c, 2));
            if (wp2 != C(0)) s += wp2 * at(c, 2);
            if (c == ax) {
                s += (Flv + FlU) * nl + (Frv + FrU) * nr;
            } else {
                const C tl = band(conv_row(0, 0, -1)) * vm[c] +
                             band(conv_row(0, 0, 0)) * vc[c] +
                             band(conv_row(0, 0, 1)) * vp[c];
                const C tr = band(conv_row(0, 1, -1)) * vm[c] +
                             band(conv_row(0, 1, 0)) * vc[c] +
                             band(conv_row(0, 1, 1)) * vp[c];
                s += Flv * nl + Frv * nr + FlU * tl + FrU * tr;
            }
            acc[c] += s;
        }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) F::store(g.out[c] + idx, acc[c]);
}

// ptrs: b0 b1 b2 | v0 v1 v2 | U0[0..2] | v0f[a][c] (a-major, 9) |
// out0 out1 out2 — 21 device pointers.
template <typename T>
int launch(const void* const* ptrs, int N0, int N1, int N2, int per0,
           int per1, int per2, void* stream) {
    const dim3 block(fluca::kBlockX, fluca::kBlockY);
    const dim3 grid = fluca::grid3d(N0, N1, N2);
    if (grid.y > fluca::kMaxGridYZ || grid.z > fluca::kMaxGridYZ)
        return (int)cudaErrorInvalidConfiguration;
    Args<T> g;
    int m = 0;
    for (int a = 0; a < 3; ++a)
        g.band[a] = static_cast<const fluca::acc_t<T>*>(ptrs[m++]);
    for (int e = 0; e < 3; ++e) g.v[e] = static_cast<const T*>(ptrs[m++]);
    for (int a = 0; a < 3; ++a) g.fu[a] = static_cast<const T*>(ptrs[m++]);
    for (int f = 0; f < 9; ++f) g.fv[f] = static_cast<const T*>(ptrs[m++]);
    for (int c = 0; c < 3; ++c)
        g.out[c] = static_cast<T*>(const_cast<void*>(ptrs[m++]));
    g.n[0] = N0;
    g.n[1] = N1;
    g.n[2] = N2;
    g.per[0] = per0;
    g.per[1] = per1;
    g.per[2] = per2;
    momentum3d_kernel<T>
        <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(g);
    return (int)cudaGetLastError();
}

static_assert(conv_row(1, 1, 1) == kBandRows - 1, "band row packing");

}  // namespace

#define FLUCA_MOMENTUM3D_EXPORT(SFX, T)                                     \
    extern "C" int fluca_momentum3d_##SFX(const void* const* ptrs, int N0,  \
                                          int N1, int N2, int per0,         \
                                          int per1, int per2,               \
                                          void* stream) {                   \
        return launch<T>(ptrs, N0, N1, N2, per0, per1, per2, stream);       \
    }

FLUCA_MOMENTUM3D_EXPORT(f32, float)
FLUCA_MOMENTUM3D_EXPORT(f64, double)
FLUCA_MOMENTUM3D_EXPORT(bf16, __nv_bfloat16)
