// Windowed dense-band applies for Hopper: kernel A (square operator band)
// and kernel B (rectangular multigrid transfer band).
//
// Kernel A replaces band_apply_pallas (fenics_eff_uptake_tpu/ops/
// pallas_kernels.py, with _band_kernel_factory):
//     Y[t*R + r, b] = coef[b] * sum_{w<W} band[t, r, w] * X[(t - halo)*R + w, b]
// X reads as zero outside [0, n); W = (2*halo + 1)*R.
//
// Kernel B replaces rect_band_apply_pallas (same file, with
// _rect_band_kernel_factory):
//     Y[t*R + r, b] = sum_{w<W} band[t, r, w] * Xp[offs[t] + w, b]
// offs is runtime int32 data and is assumed to have NO alignment (the TPU
// plans 16-aligned it for DMA; nothing here relies on that).
//
// What bounds them on an H100: the band.  At B = 20 columns each 4-byte band
// element feeds 20 FMAs, about 10 flop/byte, far below the card's balance
// point, so both kernels are bound by device-memory bandwidth on the band
// (525 MB for the h = 0.02 fine operator: ~0.16 ms at 3.35 TB/s).  The
// design therefore:
//   * reads every band element exactly once, as coalesced 16-byte loads:
//     a block stages a 64-row x 32-column slab of one row tile in shared
//     memory (odd pitch, so the per-row reads below are conflict-free);
//   * stages the matching 32 rows of the X window beside it, zero-filled
//     outside [0, n) and padded to 2*BH columns;
//   * gives each thread one band row and half of the B columns as a
//     register tile: per window column, one band value times BH window
//     values (broadcast 16-byte shared loads) in IEEE f32 FMAs -- no tensor
//     cores, no TF32, the TPU kernel's Precision.HIGHEST contract;
//   * splits each 256-row tile over 4 blocks of 128 threads, so the fine
//     band runs as ~1600 small blocks, many resident per SM, and loads the
//     next step's slabs into registers while the current step computes;
//   * fuses kernel A's optional per-column coef into the store.
// Batches above kMaxCols columns are refused (cudaErrorInvalidValue), never
// truncated; so are band pointers not 16-byte aligned and W % 4 != 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;            // band rows of one tile per block
constexpr int kThreads = 2 * kRows;  // one thread per (row, column half)
constexpr int kK = 32;               // window columns staged per step
constexpr int kPitch = kK + 1;       // odd: conflict-free row reads
constexpr int kMaxCols = 32;

template <int BH, bool RECT>
__global__ void __launch_bounds__(kThreads)
window_band_kernel(const float* __restrict__ band, const int* __restrict__ offs,
                   const float* __restrict__ X, const float* __restrict__ coef,
                   float* __restrict__ Y, int R, int W, int halo, long long n,
                   int B)
{
    // per-thread share of one step's staging: the index arithmetic is the
    // same every step, so it is computed once
    constexpr int kBandLoads = kRows * (kK / 4) / kThreads;
    constexpr int kXLoads = kK * 2 * BH / kThreads;
    static_assert(kRows * (kK / 4) % kThreads == 0, "band staging split");
    static_assert(kK * 2 * BH % kThreads == 0, "window staging split");

    __shared__ float sb[kRows * kPitch];
    __shared__ __align__(16) float sx[kK * 2 * BH];
    const int t = blockIdx.x;
    const int r0 = blockIdx.y * kRows;
    const int tid = threadIdx.x;
    const int r = tid % kRows;        // lanes of a warp: consecutive rows
    const int half = tid / kRows;     // uniform across a warp
    const int rows = min(kRows, R - r0);
    const long long start =
        RECT ? (long long)offs[t] : (long long)(t - halo) * R;
    const float* bt = band + ((long long)t * R + r0) * W;

    const float* bsrc[kBandLoads];    // row start of each staged float4
    int bcol[kBandLoads];             // its column within a step
    int bdst[kBandLoads];             // its shared-memory offset
#pragma unroll
    for (int j = 0; j < kBandLoads; ++j) {
        const int i = tid + j * kThreads;
        const int rr = i / (kK / 4);
        bcol[j] = 4 * (i % (kK / 4));
        bdst[j] = rr * kPitch + bcol[j];
        bsrc[j] = rr < rows ? bt + (long long)rr * W : nullptr;
    }
    int xrow[kXLoads];                // window row within a step, or -1
    int xcol[kXLoads];
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
        const int i = tid + j * kThreads;
        xrow[j] = i / (2 * BH);
        xcol[j] = i % (2 * BH);
        if (xcol[j] >= B) xrow[j] = -1;
    }

    float4 vb[kBandLoads];
    float vx[kXLoads];
    auto load = [&](int k0) {
#pragma unroll
        for (int j = 0; j < kBandLoads; ++j) {
            const int col = k0 + bcol[j];
            vb[j] = (bsrc[j] != nullptr && col < W)
                        ? __ldg(reinterpret_cast<const float4*>(bsrc[j] + col))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kXLoads; ++j) {
            const long long row = start + k0 + xrow[j];
            vx[j] = (xrow[j] >= 0 && row >= 0 && row < n)
                        ? __ldg(X + row * B + xcol[j]) : 0.f;
        }
    };

    float acc[BH];
#pragma unroll
    for (int j = 0; j < BH; ++j) acc[j] = 0.f;

    load(0);
    for (int k0 = 0; k0 < W; k0 += kK) {
        __syncthreads();  // the previous step's slabs are consumed
#pragma unroll
        for (int j = 0; j < kBandLoads; ++j) {
            float* d = sb + bdst[j];
            d[0] = vb[j].x;
            d[1] = vb[j].y;
            d[2] = vb[j].z;
            d[3] = vb[j].w;
        }
#pragma unroll
        for (int j = 0; j < kXLoads; ++j) sx[tid + j * kThreads] = vx[j];
        __syncthreads();
        if (k0 + kK < W) load(k0 + kK);  // next step's loads fly meanwhile
#pragma unroll 8
        for (int kk = 0; kk < kK; ++kk) {
            const float a = sb[r * kPitch + kk];
            const float* xk = sx + kk * 2 * BH + half * BH;
#pragma unroll
            for (int j = 0; j < BH; j += 4) {
                const float4 x = *reinterpret_cast<const float4*>(xk + j);
                acc[j] = fmaf(a, x.x, acc[j]);
                acc[j + 1] = fmaf(a, x.y, acc[j + 1]);
                acc[j + 2] = fmaf(a, x.z, acc[j + 2]);
                acc[j + 3] = fmaf(a, x.w, acc[j + 3]);
            }
        }
    }
    if (r < rows) {
        float* yr = Y + ((long long)t * R + r0 + r) * B;
#pragma unroll
        for (int j = 0; j < BH; ++j) {
            const int b = half * BH + j;
            if (b < B)
                yr[b] = (!RECT && coef != nullptr) ? acc[j] * coef[b] : acc[j];
        }
    }
}

template <int BH, bool RECT>
cudaError_t launch(const float* band, const int* offs, const float* X,
                   const float* coef, float* Y, int T, int R, int W, int halo,
                   long long n, int B, cudaStream_t stream)
{
    const dim3 grid(T, (R + kRows - 1) / kRows);
    window_band_kernel<BH, RECT><<<grid, kThreads, 0, stream>>>(
        band, offs, X, coef, Y, R, W, halo, n, B);
    return cudaGetLastError();
}

template <bool RECT>
cudaError_t dispatch(const float* band, const int* offs, const float* X,
                     const float* coef, float* Y, int T, int R, int W,
                     int halo, long long n, int B, cudaStream_t stream)
{
    if (T < 1 || R < 1 || R > 65535 * kRows || W < 4 || W % 4 != 0 ||
        B < 1 || B > kMaxCols ||
        reinterpret_cast<uintptr_t>(band) % 16 != 0)
        return cudaErrorInvalidValue;
    if (B <= 8)
        return launch<4, RECT>(band, offs, X, coef, Y, T, R, W, halo, n, B,
                               stream);
    if (B <= 16)
        return launch<8, RECT>(band, offs, X, coef, Y, T, R, W, halo, n, B,
                               stream);
    if (B <= 24)
        return launch<12, RECT>(band, offs, X, coef, Y, T, R, W, halo, n, B,
                                stream);
    return launch<16, RECT>(band, offs, X, coef, Y, T, R, W, halo, n, B,
                            stream);
}

}  // namespace

extern "C" {

// Kernel A.  band (T, R, W) f32, X (T*R, B) f32, coef (B,) f32 or null,
// Y (T*R, B) f32; all contiguous on the stream's device.
int feu_band_apply(const void* band, const void* X, const void* coef,
                   void* Y, int T, int R, int W, int B, void* stream)
{
    if (W % R != 0 || (W / R) % 2 != 1) return (int)cudaErrorInvalidValue;
    const int halo = (W / R - 1) / 2;
    return (int)dispatch<false>(
        static_cast<const float*>(band), nullptr,
        static_cast<const float*>(X), static_cast<const float*>(coef),
        static_cast<float*>(Y), T, R, W, halo, (long long)T * R, B,
        static_cast<cudaStream_t>(stream));
}

// Kernel B.  band (T, R, W) f32, offs (T,) int32, Xp (n_cols, B) f32,
// Y (T*R, B) f32; window rows outside [0, n_cols) read as zero.
int feu_rect_band_apply(const void* band, const void* offs, const void* Xp,
                        void* Y, int T, int R, int W, long long n_cols, int B,
                        void* stream)
{
    return (int)dispatch<true>(
        static_cast<const float*>(band), static_cast<const int*>(offs),
        static_cast<const float*>(Xp), nullptr, static_cast<float*>(Y), T, R,
        W, 0, n_cols, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
