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
// plans 16-aligned it for DMA; nothing here relies on that); window rows
// outside [0, n_cols) read as zero.
//
// What bounds them on an H100.  At B <= 20 columns each 4-byte band element
// feeds at most 20 FMAs, so both kernels are bound by device-memory bandwidth
// on the band; at B = 96 (the Stokes deflation's one wide apply) by f32 FMA
// throughput.  Three things held the first design (one 64 x 32 register-staged
// slab per block, 32-column blocks) at 1.5 TB/s and under the cuBLAS bmm at
// B = 96, and the design answers each:
//   * less than half of a band holds anything, and in every 64-row block the
//     nonzeros sit in one contiguous span of 32-column chunks.  The caller
//     passes that span per block (ops/banded.band_spans: int32 (T,
//     ceil(R/64), 2), [lo, hi) in chunks), and a block streams only its
//     span's chunks; a block with an empty span still stores its rows
//     (zeros, times the coef).  Every skipped term is fmaf(0, x, acc) ==
//     acc for finite x, so the result equals the full-width sum bit for
//     bit; a NaN or inf in X under a skipped zero does not propagate (the
//     tests and the solvers use finite X);
//   * little was in flight: the band now streams through a ring of kStages
//     shared-memory stages filled by cp.async (16-byte .cg copies for the
//     band, whose rows are 16-byte aligned; 16-byte copies for X when B % 4
//     == 0, else 4-byte .ca copies, as its rows are B * 4 bytes), so
//     kStages - 1 chunks (2 x 8 KB of band) are in flight per block while it
//     computes one, with one barrier per chunk.  The ring is kept short so
//     that more blocks reside per SM, which keeps more bytes in flight per
//     SM than a deeper ring per block would.  Out-of-range band and window elements are zero-filled by the copy
//     itself (src-size 0).  Dynamic shared memory (29-63 KB per block) is
//     enabled per instance with cudaFuncSetAttribute;
//   * B > 32 re-read the band per 32-column block.  Each instance now keeps
//     accumulators for all of its columns, up to kMaxCols = 96 (the widest
//     batch the paths use), so a band slab is read from device memory once
//     whatever B is; above 96, blocks of 96 columns.  A thread owns TM rows
//     (strided by 64 / TM) and TN columns (float4 groups interleaved across
//     the CG column groups), a register tile: per 4 window columns it reads
//     TM float4 of band and TN float4 of X from shared memory (conflict-free:
//     the band pitch is 36 floats, neighbouring lanes read neighbouring X
//     groups or broadcast) for 4 * TM * TN FMAs.
// The arithmetic is unchanged: IEEE f32 fmaf, no tensor cores, no TF32 (the
// TPU kernel's Precision.HIGHEST contract), and each output's FMA chain runs
// in ascending w over its span, so a column's values do not depend on B or
// on the instance, and equal the first design's.  Kernel A's optional
// per-column coef is fused into the store.  Band pointers not 16-byte
// aligned and W % 4 != 0 are refused (cudaErrorInvalidValue), never worked
// around.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;         // band rows of one block (SPAN_ROWS)
constexpr int kK = 32;            // window columns of one chunk (SPAN_COLS)
constexpr int kPitch = kK + 4;    // band row pitch in shared memory, floats
constexpr int kStages = 3;        // copy ring depth
constexpr int kMaxCols = 96;      // widest one-pass column block

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// src_bytes = 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one instance: TM rows x TN columns per thread, CG column groups
template <int TM, int TN, int CG>
struct Tile {
    static_assert(kRows % TM == 0 && TN % 4 == 0, "tile shape");
    static constexpr int kRG = kRows / TM;               // row groups
    static constexpr int kThreads = kRG * CG;
    static constexpr int kCols = TN * CG;                // columns per block
    static constexpr int kBandFloats = kRows * kPitch;
    static constexpr int kStageFloats = kBandFloats + kK * kCols;
    static constexpr int kSmem = kStages * kStageFloats * (int)sizeof(float);
};

template <int TM, int TN, int CG, bool RECT>
__global__ void __launch_bounds__(Tile<TM, TN, CG>::kThreads)
span_band_kernel(const float* __restrict__ band, const int* __restrict__ spans,
                 const int* __restrict__ offs, const float* __restrict__ X,
                 const float* __restrict__ coef, float* __restrict__ Y, int R,
                 int W, int halo, long long n, int B, bool xvec)
{
    using Tl = Tile<TM, TN, CG>;
    constexpr int kThreads = Tl::kThreads;
    constexpr int kCols = Tl::kCols;
    constexpr int kRG = Tl::kRG;
    extern __shared__ __align__(16) float smem[];

    const int t = blockIdx.x;
    const int nrb = gridDim.y;
    const int r0 = blockIdx.y * kRows;
    const int col0 = blockIdx.z * kCols;
    const int nb = min(kCols, B - col0);      // this block's columns
    const int rows = min(kRows, R - r0);
    const int tid = threadIdx.x;
    const int cg = tid % CG;
    const int rg = tid / CG;
    const int* sp = spans + 2 * ((long long)t * nrb + blockIdx.y);
    const int lo = max(sp[0], 0);
    const int nk = min(sp[1], (W + kK - 1) / kK) - lo;   // chunks streamed
    const long long start =
        RECT ? (long long)offs[t] : (long long)(t - halo) * R;
    const float* bt = band + ((long long)t * R + r0) * W;

    // chunk k (window columns [k*kK, k*kK + kK)) into ring stage s
    auto load_chunk = [&](int k, int s) {
        float* sb = smem + s * Tl::kStageFloats;
        float* sx = sb + Tl::kBandFloats;
        const int c0 = k * kK;
        for (int i = tid; i < kRows * (kK / 4); i += kThreads) {
            const int rr = i / (kK / 4);
            const int c = 4 * (i % (kK / 4));
            const bool ok = rr < rows && c0 + c < W;   // W % 4 == 0
            cp_async16(sb + rr * kPitch + c,
                       ok ? bt + (long long)rr * W + c0 + c : band,
                       ok ? 16 : 0);
        }
        if (xvec) {           // B % 4 == 0: 16-byte aligned X rows
            for (int i = tid; i < kK * (kCols / 4); i += kThreads) {
                const int rr = i / (kCols / 4);
                const int c = 4 * (i % (kCols / 4));
                const long long row = start + c0 + rr;
                const bool ok = c0 + rr < W && row >= 0 && row < n && c < nb;
                cp_async16(sx + rr * kCols + c,
                           ok ? X + row * B + col0 + c : X, ok ? 16 : 0);
            }
        } else {
            for (int i = tid; i < kK * kCols; i += kThreads) {
                const int rr = i / kCols;
                const int c = i % kCols;
                const long long row = start + c0 + rr;
                const bool ok = c0 + rr < W && row >= 0 && row < n && c < nb;
                cp_async4(sx + rr * kCols + c,
                          ok ? X + row * B + col0 + c : X, ok ? 4 : 0);
            }
        }
    };

    float acc[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load_chunk(lo + s, s);
        cp_async_commit();    // empty groups keep the count uniform
    }
    for (int i = 0; i < nk; ++i) {
        cp_async_wait<kStages - 2>();   // this thread's copies of chunk i
        __syncthreads();    // everyone's copies landed; chunk i-1 consumed
        const int next = i + kStages - 1;
        if (next < nk) load_chunk(lo + next, next % kStages);
        cp_async_commit();
        const float* sb = smem + (i % kStages) * Tl::kStageFloats;
        const float* sx = sb + Tl::kBandFloats;
#pragma unroll
        for (int k4 = 0; k4 < kK; k4 += 4) {
            float4 a[TM];
#pragma unroll
            for (int m = 0; m < TM; ++m)
                a[m] = *reinterpret_cast<const float4*>(
                    sb + (rg + m * kRG) * kPitch + k4);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float* xk = sx + (k4 + q) * kCols;
#pragma unroll
                for (int j = 0; j < TN / 4; ++j) {
                    const float4 x = *reinterpret_cast<const float4*>(
                        xk + 4 * (j * CG + cg));
#pragma unroll
                    for (int m = 0; m < TM; ++m) {
                        const float av = q == 0   ? a[m].x
                                         : q == 1 ? a[m].y
                                         : q == 2 ? a[m].z
                                                  : a[m].w;
                        acc[m][4 * j] = fmaf(av, x.x, acc[m][4 * j]);
                        acc[m][4 * j + 1] = fmaf(av, x.y, acc[m][4 * j + 1]);
                        acc[m][4 * j + 2] = fmaf(av, x.z, acc[m][4 * j + 2]);
                        acc[m][4 * j + 3] = fmaf(av, x.w, acc[m][4 * j + 3]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int m = 0; m < TM; ++m) {
        const int r = rg + m * kRG;
        if (r >= rows) continue;
        float* yr = Y + ((long long)t * R + r0 + r) * B + col0;
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int b = 4 * (j * CG + cg) + e;
                if (b < nb)
                    yr[b] = (!RECT && coef != nullptr)
                                ? acc[m][4 * j + e] * coef[col0 + b]
                                : acc[m][4 * j + e];
            }
        }
    }
}

template <int TM, int TN, int CG, bool RECT>
cudaError_t launch(const float* band, const int* spans, const int* offs,
                   const float* X, const float* coef, float* Y, int T, int R,
                   int W, int halo, long long n, int B, cudaStream_t stream)
{
    using Tl = Tile<TM, TN, CG>;
    // the dynamic shared memory ceiling, raised once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
        err = cudaFuncSetAttribute(span_band_kernel<TM, TN, CG, RECT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Tl::kSmem);
        if (err != cudaSuccess) return err;
        raised[dev] = true;
    }
    const bool xvec =
        B % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
    const dim3 grid(T, (R + kRows - 1) / kRows,
                    (B + Tl::kCols - 1) / Tl::kCols);
    span_band_kernel<TM, TN, CG, RECT><<<grid, Tl::kThreads, Tl::kSmem,
                                         stream>>>(
        band, spans, offs, X, coef, Y, R, W, halo, n, B, xvec);
    return cudaGetLastError();
}

template <bool RECT>
cudaError_t dispatch(const float* band, const int* spans, const int* offs,
                     const float* X, const float* coef, float* Y, int T,
                     int R, int W, int halo, long long n, int B,
                     cudaStream_t stream)
{
    if (T < 1 || R < 1 || R > 65535 * kRows || W < 4 || W % 4 != 0 ||
        B < 1 || (B + kMaxCols - 1) / kMaxCols > 65535 ||
        reinterpret_cast<uintptr_t>(band) % 16 != 0)
        return cudaErrorInvalidValue;
    // register tiles: one column block up to 96 columns
    if (B <= 4)
        return launch<1, 4, 1, RECT>(band, spans, offs, X, coef, Y, T, R, W,
                                     halo, n, B, stream);
    if (B <= 8)
        return launch<1, 4, 2, RECT>(band, spans, offs, X, coef, Y, T, R, W,
                                     halo, n, B, stream);
    if (B <= 24)
        return launch<4, 4, 6, RECT>(band, spans, offs, X, coef, Y, T, R, W,
                                     halo, n, B, stream);
    if (B <= 48)
        return launch<4, 8, 6, RECT>(band, spans, offs, X, coef, Y, T, R, W,
                                     halo, n, B, stream);
    return launch<4, 8, 12, RECT>(band, spans, offs, X, coef, Y, T, R, W,
                                  halo, n, B, stream);
}

}  // namespace

extern "C" {

// Kernel A.  band (T, R, W) f32, spans (T, ceil(R/64), 2) int32, X (T*R, B)
// f32, coef (B,) f32 or null, Y (T*R, B) f32; all contiguous on the
// stream's device.
int feu_band_apply(const void* band, const void* spans, const void* X,
                   const void* coef, void* Y, int T, int R, int W, int B,
                   void* stream)
{
    if (W % R != 0 || (W / R) % 2 != 1) return (int)cudaErrorInvalidValue;
    const int halo = (W / R - 1) / 2;
    return (int)dispatch<false>(
        static_cast<const float*>(band), static_cast<const int*>(spans),
        nullptr, static_cast<const float*>(X),
        static_cast<const float*>(coef), static_cast<float*>(Y), T, R, W,
        halo, (long long)T * R, B, static_cast<cudaStream_t>(stream));
}

// Kernel B.  band (T, R, W) f32, spans (T, ceil(R/64), 2) int32, offs (T,)
// int32, Xp (n_cols, B) f32, Y (T*R, B) f32.
int feu_rect_band_apply(const void* band, const void* spans, const void* offs,
                        const void* Xp, void* Y, int T, int R, int W,
                        long long n_cols, int B, void* stream)
{
    return (int)dispatch<true>(
        static_cast<const float*>(band), static_cast<const int*>(spans),
        static_cast<const int*>(offs), static_cast<const float*>(Xp),
        nullptr, static_cast<float*>(Y), T, R, W, 0, n_cols, B,
        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
