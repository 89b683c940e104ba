// The marching kernel template of the 3-D Poisson stencil, shared by
// csrc/poisson3d.cu (the apply, residual and smooth, unsharded and halo
// instances; its header says what the kernel computes and why it is built
// so) and csrc/probes.cu (poisson3d_variant, the apply with parts of its
// body stripped, launched with the apply's geometry).
//
// STRIP selects what a variant leaves of the apply (MODE 0): kRebuilt the
// whole body, with the in-plane neighbours past the grid's walls read from
// edge planes handed in (the reference's roll patches, staged per block in
// shared memory) instead of as zeros; kNoRoll the same with every other
// in-plane neighbour read as the centre value; kNoComp p * 1.0000001f
// written through the march, with no neighbour load and no stencil
// arithmetic. The variants run on the unsharded path (HALO false) with
// wall in-plane axes. poisson3d.cu's instances are kNone.
//
// In an anonymous namespace: each source that includes it compiles its
// own instances.
#pragma once

#include "stencil_common.cuh"

namespace {

enum Strip : int { kNone = -1, kRebuilt = 0, kNoRoll = 1, kNoComp = 2 };

constexpr int kLanes = 32;       // threads of a block along k (blockDim.x)
constexpr int kMaxThreads = 512;
constexpr int kMaxGridYZ = 65535;
constexpr int kVariantRunMax = 8;  // planes of a variant's run (its staged edges)

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
template <typename T, int MODE, bool HALO, int STRIP = kNone>
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
    // a variant's edges (the reference's roll patches) for the run, staged
    // with the coefficients by the blocks at the grid's in-plane walls:
    // se1[side][plane][lane] from the axis-1 edge planes (rows 0, n1-1),
    // se2[side][plane][row] from the axis-2 ones (columns 0, n2-1)
    const C* se1 = nullptr;
    const C* se2 = nullptr;
    if constexpr (STRIP == kRebuilt || STRIP == kNoRoll) {
        const bool lo1 = j0 == 0, hi1 = j0 + rows >= n1, lo2 = k0 == 0, hi2 = k0 + kLanes >= n2;
        __shared__ C se[2 * kVariantRunMax * (kLanes + kMaxThreads / kLanes)];
        se1 = se;
        se2 = se + 2 * kVariantRunMax * kLanes;
        if (lo1 || hi1) {
            for (int q = t; q < 2 * nrun * kLanes; q += kLanes * rows) {
                const int side = q / (nrun * kLanes), r = q - side * nrun * kLanes;
                const int x = r / kLanes, lane = r - x * kLanes;
                if ((side ? hi1 : lo1) && k0 + lane < n2)
                    se[(side * kVariantRunMax + x) * kLanes + lane] =
                        F::load((side ? h.p.hi[1] : h.p.lo[1]) + (i0 + x) * g.est[1][0] + k0 + lane);
            }
        }
        if (lo2 || hi2) {
            const int m = kMaxThreads / kLanes;
            for (int q = t; q < 2 * nrun * rows; q += kLanes * rows) {
                const int side = q / (nrun * rows), r = q - side * nrun * rows;
                const int x = r / rows, row = r - x * rows;
                if ((side ? hi2 : lo2) && j0 + row < n1)
                    se[2 * kVariantRunMax * kLanes + (side * kVariantRunMax + x) * m + row] =
                        F::load((side ? h.p.hi[2] : h.p.lo[2]) + (i0 + x) * g.est[2][0] + j0 + row);
            }
        }
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
        T* const o = h.out + pl + ctr;
        if constexpr (STRIP == kNoComp) {
            F::store(o, fluca::mul(pc, C(1.0000001f)));
            pm = pc;
            pc = pp;
            return;
        }
        C nb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if constexpr (STRIP == kNoRoll) {
                nb[q] = pc;
            } else {
                const C x = F::load(nptr[q]);
                nb[q] = nbs[q].where == fluca::kZero ? C(0) : x;
            }
        }
        if constexpr (STRIP == kRebuilt || STRIP == kNoRoll) {
            // a variant's neighbours past the in-plane walls: the staged edges
            if (j == 0 || j == n1 - 1 || k == 0 || k == n2 - 1) {
                const int m = kMaxThreads / kLanes;
                if (j == 0) nb[0] = se1[ii * kLanes + threadIdx.x];
                if (j == n1 - 1) nb[1] = se1[(kVariantRunMax + ii) * kLanes + threadIdx.x];
                if (k == 0) nb[2] = se2[ii * m + threadIdx.y];
                if (k == n2 - 1) nb[3] = se2[(kVariantRunMax + ii) * m + threadIdx.y];
            }
        }
        const C bb = MODE >= 1 ? F::load(h.b + pl + ctr) : C(0);
        const C ww = MODE == 2 ? F::load(h.w + pl + ctr) : C(0);
        C a[4];
        fluca::plane_coeffs(s0 + 4 * ii, a);  // A0[-1], A0[0], A0[+1], H0

        const C sa = fluca::poisson3d_axis(a[0], a[1], a[2], pm, pc, pp);
        const C sb = fluca::poisson3d_axis(c1m, c1c, c1p, nb[0], pc, nb[1]);
        const C sc = fluca::poisson3d_axis(c2m, c2c, c2p, nb[2], pc, nb[3]);
        const C sp = fluca::poisson3d_sp(sa, sb, sc, a[3], hj, hk);
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

// mode: the apply (0), residual (1) or smooth (2); a stripped variant is
// an apply.
template <typename T, bool HALO, int STRIP = kNone>
int launch(int mode, Args<T> h, const int* plan, void* stream) {
    if (h.g.st[2] != 1 || !plan_fits<T>(h.g, plan) || (STRIP != kNone && plan[4] > kVariantRunMax))
        return (int)cudaErrorInvalidConfiguration;
    h.run = plan[4];
    const dim3 grid(plan[0], plan[1], plan[2]), block(kLanes, plan[3]);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (STRIP != kNone) {
        if (mode != 0) return (int)cudaErrorInvalidValue;
        poisson3d_kernel<T, 0, HALO, STRIP><<<grid, block, plan[5], s>>>(h);
    } else {
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
    }
    return (int)cudaGetLastError();
}

}  // namespace
