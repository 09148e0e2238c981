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
//     SM than a deeper ring per block would.  Out-of-range band and window
//     elements are zero-filled by the copy itself (src-size 0).  Dynamic
//     shared memory (29-63 KB per block) is enabled per instance with
//     cudaFuncSetAttribute;
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
//
// The bf16 operand forms (the TPU kernels' single-pass MXU branch, reached by
// the bf16 cycle and by bf16 transfer bands) run the same design on 2-byte
// operands:
//   A          band, X, coef and Y in bf16;
//   B, form 1  band in bf16, X in f32 and rounded to bf16 where it is read
//              from shared memory (round to nearest even), Y in f32;
//   B, form 2  band, X and Y in bf16.
// A bf16 x bf16 product is exact in f32, so the arithmetic is the f32
// kernel's on upcast operands: fmaf in ascending w over the span, the coef
// product in f32, one rounding where Y is bf16.  No tensor cores.  A 16-byte
// copy carries 8 band values, so the band needs W % 8 == 0 and the ring's
// band pitch is 40 values (80 bytes: rows stay 16-byte aligned).  A thread
// reads 4 bf16 values as one 8-byte word pair and upcasts them by a shift
// where it uses them.  Rounding f32 X to bf16 (B's form 1) is dearer than a
// shift and an X value is read by every row group, so there the block
// converts a landed chunk once (band upcast, X rounded to bf16 and back)
// into an f32 copy of one stage, in the f32 kernel's layout, and the FMA
// loop is the f32 kernel's on that copy; a second barrier per chunk
// separates the conversion from the loop.  (Converting once in every bf16
// form was tried on the card: no faster with bf16 X, and slower at B <= 4,
// where one thread uses each band value.)  X rows are B * 2 bytes: 16-byte
// copies when B % 8 == 0, 4-byte copies (two values) when B is even, and
// plain 2-byte loads stored to the ring stage when B is odd (cp.async copies
// no less than 4 bytes); the barrier that publishes a chunk's copies
// publishes those stores too.  The spans of the f32 band serve
// its bf16 copy: bf16 has f32's exponent range, so rounding turns no nonzero
// into zero short of f32's own subnormals, and a value that did round to
// zero only adds an exact 0 to the sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;         // band rows of one block (SPAN_ROWS)
constexpr int kK = 32;            // window columns of one chunk (SPAN_COLS)
// band row pitch in shared memory, in values: the chunk plus 16 bytes
template <typename TB>
constexpr int kPitchOf = kK + 16 / (int)sizeof(TB);
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

// four consecutive values from shared memory, upcast to f32 (a bf16 is the
// high half of the f32 of the same value)
__device__ __forceinline__ float4 load4(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p)
{
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float round_bf16(float v)
{
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v)
{
    *p = __float2bfloat16_rn(v);
}

// how a block copies its X rows into a ring stage
enum XCopy { kXScalar = 0, kXWord = 1, kXVec = 2 };

// one instance: TM rows x TN columns per thread, CG column groups; band
// values of type TB, X values of type TX
template <int TM, int TN, int CG, typename TB = float, typename TX = float>
struct Tile {
    static_assert(kRows % TM == 0 && TN % 4 == 0, "tile shape");
    static constexpr int kRG = kRows / TM;               // row groups
    static constexpr int kThreads = kRG * CG;
    static constexpr int kCols = TN * CG;                // columns per block
    static constexpr int kPitch = kPitchOf<TB>;
    static constexpr int kBandBytes = kRows * kPitch * (int)sizeof(TB);
    static constexpr int kStageBytes =
        kBandBytes + kK * kCols * (int)sizeof(TX);
    static_assert(kBandBytes % 16 == 0 && kStageBytes % 16 == 0, "stages");
    // a bf16 band with f32 X: one more stage, in f32, for the FMA loop
    static constexpr bool kConvert = sizeof(TB) == 2 && sizeof(TX) == 4;
    static constexpr int kF32Floats = kRows * kPitchOf<float> + kK * kCols;
    static constexpr int kSmem =
        kStages * kStageBytes + (kConvert ? kF32Floats * 4 : 0);
};

// One chunk's FMAs of a thread (row group rg, column group cg): per 4 window
// columns, TM x 4 band values and TN x 4 X values from a stage (f32, or bf16
// upcast by load4) for 4 * TM * TN FMAs, each output's chain in ascending w.
template <int TM, int TN, int CG, int PITCH, typename SB, typename SX>
__device__ __forceinline__ void fma_chunk(float (&acc)[TM][TN], const SB* sb,
                                          const SX* sx, int rg, int cg)
{
    constexpr int kRG = kRows / TM;
    constexpr int kCols = TN * CG;
#pragma unroll
    for (int k4 = 0; k4 < kK; k4 += 4) {
        float4 a[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m)
            a[m] = load4(sb + (rg + m * kRG) * PITCH + k4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const SX* xk = sx + (k4 + q) * kCols;
#pragma unroll
            for (int j = 0; j < TN / 4; ++j) {
                const float4 x = load4(xk + 4 * (j * CG + cg));
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

// TB, TX, TY: the types of the band, of X and of Y (and coef).  f32 X under
// a bf16 band is rounded to bf16 where its chunk is converted to f32.
template <int TM, int TN, int CG, bool RECT, typename TB, typename TX,
          typename TY>
__global__ void __launch_bounds__(Tile<TM, TN, CG, TB, TX>::kThreads)
span_band_kernel(const TB* __restrict__ band, const int* __restrict__ spans,
                 const int* __restrict__ offs, const TX* __restrict__ X,
                 const TY* __restrict__ coef, TY* __restrict__ Y, int R,
                 int W, int halo, long long n, int B, int xcopy)
{
    using Tl = Tile<TM, TN, CG, TB, TX>;
    constexpr int kThreads = Tl::kThreads;
    constexpr int kCols = Tl::kCols;
    constexpr int kRG = Tl::kRG;
    constexpr int kPitch = Tl::kPitch;          // of the ring's band rows
    constexpr int kPitchF = kPitchOf<float>;    // of the rows the FMAs read
    constexpr int kEB = 16 / (int)sizeof(TB);   // band values per 16 bytes
    constexpr int kEX = 16 / (int)sizeof(TX);   // X values per 16 bytes
    constexpr int kWX = 4 / (int)sizeof(TX);    // X values per 4 bytes
    extern __shared__ __align__(16) unsigned char smem[];

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
    const TB* bt = band + ((long long)t * R + r0) * W;

    // chunk k (window columns [k*kK, k*kK + kK)) into ring stage s
    auto load_chunk = [&](int k, int s) {
        TB* sb = reinterpret_cast<TB*>(smem + s * Tl::kStageBytes);
        TX* sx = reinterpret_cast<TX*>(smem + s * Tl::kStageBytes
                                       + Tl::kBandBytes);
        const int c0 = k * kK;
        for (int i = tid; i < kRows * (kK / kEB); i += kThreads) {
            const int rr = i / (kK / kEB);
            const int c = kEB * (i % (kK / kEB));
            const bool ok = rr < rows && c0 + c < W;   // W % kEB == 0
            cp_async16(sb + rr * kPitch + c,
                       ok ? bt + (long long)rr * W + c0 + c : band,
                       ok ? 16 : 0);
        }
        if (xcopy == kXVec) {     // B % kEX == 0: 16-byte aligned X rows
            for (int i = tid; i < kK * (kCols / kEX); i += kThreads) {
                const int rr = i / (kCols / kEX);
                const int c = kEX * (i % (kCols / kEX));
                const long long row = start + c0 + rr;
                const bool ok = c0 + rr < W && row >= 0 && row < n && c < nb;
                cp_async16(sx + rr * kCols + c,
                           ok ? X + row * B + col0 + c : X, ok ? 16 : 0);
            }
        } else if (xcopy == kXWord) {   // B % kWX == 0: 4-byte pieces
            for (int i = tid; i < kK * (kCols / kWX); i += kThreads) {
                const int rr = i / (kCols / kWX);
                const int c = kWX * (i % (kCols / kWX));
                const long long row = start + c0 + rr;
                const bool ok = c0 + rr < W && row >= 0 && row < n && c < nb;
                cp_async4(sx + rr * kCols + c,
                          ok ? X + row * B + col0 + c : X, ok ? 4 : 0);
            }
        } else {                  // 2-byte values at odd B: load and store
            for (int i = tid; i < kK * kCols; i += kThreads) {
                const int rr = i / kCols;
                const int c = i % kCols;
                const long long row = start + c0 + rr;
                const bool ok = c0 + rr < W && row >= 0 && row < n && c < nb;
                sx[rr * kCols + c] = ok ? X[row * B + col0 + c] : TX(0.f);
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
        const unsigned char* st = smem + (i % kStages) * Tl::kStageBytes;
        if constexpr (Tl::kConvert) {
            // the landed chunk, once, into the f32 stage (free: everyone
            // passed the barrier above after the last chunk's FMAs)
            float* fb = reinterpret_cast<float*>(smem
                                                 + kStages * Tl::kStageBytes);
            float* fx = fb + kRows * kPitchF;
            const TB* rb = reinterpret_cast<const TB*>(st);
            const TX* rx = reinterpret_cast<const TX*>(st + Tl::kBandBytes);
            for (int e = tid; e < kRows * (kK / 4); e += kThreads) {
                const int rr = e / (kK / 4);
                const int c = 4 * (e % (kK / 4));
                *reinterpret_cast<float4*>(fb + rr * kPitchF + c) =
                    load4(rb + rr * kPitch + c);
            }
            for (int e = tid; e < kK * kCols / 4; e += kThreads) {
                float4 x = load4(rx + 4 * e);
                x.x = round_bf16(x.x);
                x.y = round_bf16(x.y);
                x.z = round_bf16(x.z);
                x.w = round_bf16(x.w);
                *reinterpret_cast<float4*>(fx + 4 * e) = x;
            }
            __syncthreads();
            fma_chunk<TM, TN, CG, kPitchF>(acc, fb, fx, rg, cg);
        } else {
            fma_chunk<TM, TN, CG, kPitch>(
                acc, reinterpret_cast<const TB*>(st),
                reinterpret_cast<const TX*>(st + Tl::kBandBytes), rg, cg);
        }
    }

#pragma unroll
    for (int m = 0; m < TM; ++m) {
        const int r = rg + m * kRG;
        if (r >= rows) continue;
        TY* yr = Y + ((long long)t * R + r0 + r) * B + col0;
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int b = 4 * (j * CG + cg) + e;
                if (b < nb)
                    store(yr + b,
                          (!RECT && coef != nullptr)
                              ? acc[m][4 * j + e] * as_float(coef[col0 + b])
                              : acc[m][4 * j + e]);
            }
        }
    }
}

template <int TM, int TN, int CG, bool RECT, typename TB, typename TX,
          typename TY>
cudaError_t launch(const TB* band, const int* spans, const int* offs,
                   const TX* X, const TY* coef, TY* Y, int T, int R,
                   int W, int halo, long long n, int B, cudaStream_t stream)
{
    using Tl = Tile<TM, TN, CG, TB, TX>;
    // the dynamic shared memory ceiling, raised once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
        err = cudaFuncSetAttribute(
            span_band_kernel<TM, TN, CG, RECT, TB, TX, TY>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
        if (err != cudaSuccess) return err;
        raised[dev] = true;
    }
    // the widest copy X's rows allow: 16 bytes, 4 bytes, single 2-byte
    // values (a block's first column is a multiple of 4 * CG)
    constexpr int kEX = 16 / (int)sizeof(TX);
    constexpr int kWX = 4 / (int)sizeof(TX);
    const uintptr_t xa = reinterpret_cast<uintptr_t>(X);
    int xcopy = kXScalar;
    if (B % kEX == 0 && Tl::kCols % kEX == 0 && xa % 16 == 0)
        xcopy = kXVec;
    else if (B % kWX == 0 && xa % 4 == 0)
        xcopy = kXWord;
    const dim3 grid(T, (R + kRows - 1) / kRows,
                    (B + Tl::kCols - 1) / Tl::kCols);
    span_band_kernel<TM, TN, CG, RECT, TB, TX, TY>
        <<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
            band, spans, offs, X, coef, Y, R, W, halo, n, B, xcopy);
    return cudaGetLastError();
}

template <bool RECT, typename TB, typename TX, typename TY>
cudaError_t dispatch(const TB* band, const int* spans, const int* offs,
                     const TX* X, const TY* coef, TY* Y, int T,
                     int R, int W, int halo, long long n, int B,
                     cudaStream_t stream)
{
    constexpr int kEB = 16 / (int)sizeof(TB);   // band values per copy
    if (T < 1 || R < 1 || R > 65535 * kRows || W < kEB || W % kEB != 0 ||
        B < 1 || (B + kMaxCols - 1) / kMaxCols > 65535 ||
        reinterpret_cast<uintptr_t>(band) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(X) % sizeof(TX) != 0)
        return cudaErrorInvalidValue;
    // register tiles: one column block up to 96 columns
#define FEU_LAUNCH(TM, TN, CG)                                              \
    launch<TM, TN, CG, RECT, TB, TX, TY>(band, spans, offs, X, coef, Y, T,  \
                                         R, W, halo, n, B, stream)
    if (B <= 4) return FEU_LAUNCH(1, 4, 1);
    if (B <= 8) return FEU_LAUNCH(1, 4, 2);
    if (B <= 24) return FEU_LAUNCH(4, 4, 6);
    if (B <= 48) return FEU_LAUNCH(4, 8, 6);
    return FEU_LAUNCH(4, 8, 12);
#undef FEU_LAUNCH
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
        static_cast<const float*>(nullptr), static_cast<float*>(Y), T, R, W,
        0, n_cols, B,
        static_cast<cudaStream_t>(stream));
}

// Kernel A on bf16 operands.  band (T, R, W) with W % 8 == 0, X (T*R, B),
// coef (B,) or null and Y (T*R, B) all bf16; spans as for the f32 band.
int feu_band_apply_bf16(const void* band, const void* spans, const void* X,
                        const void* coef, void* Y, int T, int R, int W, int B,
                        void* stream)
{
    if (W % R != 0 || (W / R) % 2 != 1) return (int)cudaErrorInvalidValue;
    const int halo = (W / R - 1) / 2;
    using bf16 = __nv_bfloat16;
    return (int)dispatch<false>(
        static_cast<const bf16*>(band), static_cast<const int*>(spans),
        nullptr, static_cast<const bf16*>(X), static_cast<const bf16*>(coef),
        static_cast<bf16*>(Y), T, R, W, halo, (long long)T * R, B,
        static_cast<cudaStream_t>(stream));
}

// Kernel B on a bf16 band with W % 8 == 0.  x_bf16 = 0: Xp f32, rounded to
// bf16 as it is read, Y f32; x_bf16 = 1: Xp and Y bf16.
int feu_rect_band_apply_bf16(const void* band, const void* spans,
                             const void* offs, const void* Xp, void* Y, int T,
                             int R, int W, long long n_cols, int B,
                             int x_bf16, void* stream)
{
    using bf16 = __nv_bfloat16;
    const bf16* bd = static_cast<const bf16*>(band);
    const int* sp = static_cast<const int*>(spans);
    const int* of = static_cast<const int*>(offs);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16)
        return (int)dispatch<true>(bd, sp, of, static_cast<const bf16*>(Xp),
                                   static_cast<const bf16*>(nullptr),
                                   static_cast<bf16*>(Y), T, R, W, 0, n_cols,
                                   B, s);
    return (int)dispatch<true>(bd, sp, of, static_cast<const float*>(Xp),
                               static_cast<const float*>(nullptr),
                               static_cast<float*>(Y), T, R, W, 0, n_cols, B,
                               s);
}

}  // extern "C"
