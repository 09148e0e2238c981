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
// This file holds their bf16 operand forms; the f32 forms are in
// band_f32.cu.  Both kernels here share one blocking: a block owns 64 band
// rows of one tile (kRows, SPAN_ROWS) and streams the 32-column chunks (kK,
// SPAN_COLS) of their column span through a ring of cp.async stages.  Less
// than half of a band holds anything, and in every 64-row block the
// nonzeros sit in one contiguous span of chunks: the caller passes that
// span per block (ops/banded.band_spans: int32 (T, ceil(R/64), 2), [lo, hi)
// in chunks), and a block streams only its span's chunks; a block with an
// empty span still stores its rows (zeros, times the coef).  A skipped
// chunk is all-zero band and adds nothing.  Band copies are 16-byte .cg
// cp.async (rows 16-byte aligned); out-of-range band elements are
// zero-filled by the copy itself (src-size 0).  Dynamic shared memory is
// enabled per instance with cudaFuncSetAttribute.
//
// The bf16 operand forms (the TPU kernels' single-pass MXU branch, reached
// by the bf16 cycle and by bf16 transfer bands):
//   A          band, X, coef and Y in bf16;
//   B, form 1  band in bf16, X in f32 rounded to bf16 (round to nearest
//              even, as the plain version rounds it), Y in f32;
//   B, form 2  band, X and Y in bf16.
// The TPU kernels contract bf16 operands on the MXU with f32 accumulation
// (preferred_element_type=f32) in an order the MXU chooses; here the same
// contract runs on Hopper's tensor cores: mma.sync.m16n8k16.row.col
// .f32.bf16.bf16.f32, products exact, f32 accumulators in registers, the
// coef product in f32 and one rounding where Y is bf16.  Each 2-byte band
// value feeds B multiply-adds (at most 96 FLOPs per byte), far below the
// tensor cores' ridge, so with the products off the issue path these forms
// are bound by the band's bytes.  The design:
//   * four warps, one per 16 rows of the 64-row block; each warp holds all
//     of the block's columns as NT = ceil(cols / 8) n8 tiles of f32
//     accumulators (NT in {1, 3, 6, 12}: at most 96 columns, 48 registers);
//     above 96 columns, blocks of 96 columns;
//   * per 32-column chunk two k16 steps, each one ldmatrix.x4 of the band
//     (16 x 16) and one ldmatrix.x4.trans of the X stage per two n8 tiles
//     (x2.trans for an odd last tile), then NT mma.  The ring's band pitch of
//     40 bf16 (80 bytes) puts the 8 rows of an 8 x 8 matrix on 8 distinct
//     16-byte bank groups; the X stage holds NT * 8 columns, zero beyond the
//     block's, at a pitch of an odd number of 16-byte units: conflict-free;
//   * X rows are B * 2 (or B * 4) bytes with no alignment at odd B or odd
//     window starts.  Each window row's piece is copied by 16-byte cp.async
//     over its aligned superset (every 16-byte unit read holds a byte of the
//     row, so none leaves X's pages) into a raw area of the ring stage; once
//     landed, the block repacks the chunk's rows into the bf16 X stage,
//     rounding f32 X by cvt.rn.bf16x2.f32 on the way and zeroing rows
//     outside the window or X and columns past the block's.  No extra pass
//     over X in device memory.  The copies and the repack are most of a
//     chunk's instructions, and where few blocks share an SM they set its
//     pace: the repack moves 8 values per 16-byte store (4 at one n8 tile,
//     where 8 would leave three quarters of the threads idle), and the
//     rows a chunk reads are one range worked out once per chunk;
//   * the repack of chunk i + 1 runs beside the mma of chunk i, into the
//     other of two X stages, so one barrier per chunk still serves: ring of
//     kTcStages = 4 (chunk i + 1 landed, i + 2 and i + 3 in flight).  A
//     chunk row of band is 64 bytes, half a 128-byte line: the copies ask
//     L2 for the whole line (.L2::128B), so the next chunk's half is there;
//   * batch invariance: every instance runs the same k16 steps in ascending
//     chunk order over the same span, and the m16n8 output tiles are
//     independent along n, so a column's values do not depend on B or on
//     the instance.  The sums run in the tensor cores' order, not in
//     ascending w: a bf16 Y is held to the plain version by tolerance
//     (>= 99% equal, each within one bf16 ulp or 1e-5 of its sum of
//     |terms|), an f32 Y by 1e-5 of its sum of |terms|.
// A 16-byte copy carries 8 band values, so the band needs W % 8 == 0.  The
// spans of the f32 band serve its bf16 copy: bf16 has f32's exponent range,
// so rounding turns no nonzero into zero short of f32's own subnormals, and
// a value that did round to zero only adds an exact 0 to the sum.
// Band pointers not 16-byte aligned and W % 8 != 0 are refused
// (cudaErrorInvalidValue), never worked around.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;         // band rows of one block (SPAN_ROWS)
constexpr int kK = 32;            // window columns of one chunk (SPAN_COLS)
// band row pitch in shared memory, in values: the chunk plus 16 bytes
template <typename TB>
constexpr int kPitchOf = kK + 16 / (int)sizeof(TB);
constexpr int kTcStages = 4;      // copy ring depth, tensor-core form
constexpr int kTcThreads = 128;   // four warps, 16 rows each
constexpr int kMaxCols = 96;      // widest one-pass column block

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a 16-byte copy (src_bytes = 0 fills the destination with zeros and reads
// nothing), with the rest of the 128-byte line prefetched into L2: a bf16
// chunk row is 64 bytes, and the next chunk reads the line's other half
__device__ __forceinline__ void cp_async16_pf(void* dst, const void* src,
                                              int src_bytes)
{
    asm volatile(
        "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
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

// ---------------------------------------------------------------------------
// the bf16 operand forms: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col): bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi)
{
    unsigned d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v)
{
    return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v)
{
    *p = __float2bfloat16_rn(v);
}

// one instance: NT n8 tiles of columns per warp, X of type TX
template <int NT, typename TX>
struct TcTile {
    static constexpr int kCols = 8 * NT;                 // columns per block
    // the bf16 X stage's row pitch: an odd number of 16-byte units
    static constexpr int kXPitch = kCols + (NT % 2 == 0 ? 8 : 0);
    // 16-byte copies per raw X row: the row's bytes plus a misalignment
    static constexpr int kPieces = kCols * (int)sizeof(TX) / 16 + 1;
    static constexpr int kPitch = kPitchOf<bf16>;        // 40: 80 bytes
    static constexpr int kBandBytes = kRows * kPitch * 2;
    static constexpr int kRawBytes = kK * kPieces * 16;
    static constexpr int kStageBytes = kBandBytes + kRawBytes;
    static constexpr int kXsBytes = kK * kXPitch * 2;
    static_assert(kBandBytes % 16 == 0 && kXsBytes % 16 == 0, "stages");
    static constexpr int kSmem = kTcStages * kStageBytes + 2 * kXsBytes;
};

// TX: X's type (bf16, or f32 rounded to bf16 in the repack); TY: Y's and
// coef's
template <int NT, bool RECT, typename TX, typename TY>
__global__ void __launch_bounds__(kTcThreads)
tc_band_kernel(const bf16* __restrict__ band, const int* __restrict__ spans,
               const int* __restrict__ offs, const TX* __restrict__ X,
               const TY* __restrict__ coef, TY* __restrict__ Y, int R, int W,
               int halo, long long n, int B)
{
    using Tl = TcTile<NT, TX>;
    constexpr int kCols = Tl::kCols;
    constexpr int kPitch = Tl::kPitch;
    constexpr int kXPitch = Tl::kXPitch;
    constexpr int kRawPitch = Tl::kPieces * 16;          // bytes
    constexpr int kES = (int)sizeof(TX);
    constexpr int kThreads = kTcThreads;
    extern __shared__ __align__(16) unsigned char smem[];

    const int t = blockIdx.x;
    const int nrb = gridDim.y;
    const int r0 = blockIdx.y * kRows;
    const int col0 = blockIdx.z * kCols;
    const int nb = min(kCols, B - col0);      // this block's columns
    const int rows = min(kRows, R - r0);
    const int tid = threadIdx.x;
    const int wm = tid / 32;           // the warp's 16 rows
    const int lane = tid % 32;
    const int* sp = spans + 2 * ((long long)t * nrb + blockIdx.y);
    const int lo = max(sp[0], 0);
    const int nk = min(sp[1], (W + kK - 1) / kK) - lo;   // chunks streamed
    const long long start =
        RECT ? (long long)offs[t] : (long long)(t - halo) * R;
    const bf16* bt = band + ((long long)t * R + r0) * W;
    bf16* xstage = reinterpret_cast<bf16*>(smem + kTcStages * Tl::kStageBytes);

    // the window rows [rlo, rhi) of the chunk at column c0 that read X
    // (inside the window and inside X); the others read as zero
    auto x_rows = [&](int c0, int& rlo, int& rhi) {
        const long long r0x = start + c0;           // X row of window row 0
        rlo = (int)min((long long)kK, max(0LL, -r0x));
        rhi = (int)max(0LL, min((long long)min(kK, W - c0), n - r0x));
    };

    // chunk k (window columns [k*kK, k*kK + kK)) into ring stage s: the
    // band rows, and each X row's columns [col0, col0 + nb) as the 16-byte
    // units that hold them
    auto load_chunk = [&](int k, int s) {
        unsigned char* st = smem + s * Tl::kStageBytes;
        bf16* sb = reinterpret_cast<bf16*>(st);
        const int c0 = k * kK;
        for (int i = tid; i < kRows * (kK / 8); i += kThreads) {
            const int rr = i / (kK / 8);
            const int c = 8 * (i % (kK / 8));
            const bool ok = rr < rows && c0 + c < W;   // W % 8 == 0
            cp_async16_pf(sb + rr * kPitch + c,
                          ok ? bt + (long long)rr * W + c0 + c : band,
                          ok ? 16 : 0);
        }
        unsigned char* raw = st + Tl::kBandBytes;
        int rlo, rhi;
        x_rows(c0, rlo, rhi);
        for (int i = tid; i < kK * Tl::kPieces; i += kThreads) {
            const int rr = i / Tl::kPieces;
            const int p = i % Tl::kPieces;
            if (rr < rlo || rr >= rhi) continue;
            const uintptr_t a0 = reinterpret_cast<uintptr_t>(
                X + (start + c0 + rr) * B + col0);
            const uintptr_t a = a0 & ~uintptr_t(15);
            if (a + 16 * p < a0 + (uintptr_t)nb * kES)
                cp_async16_pf(raw + rr * kRawPitch + 16 * p,
                              reinterpret_cast<const void*>(a + 16 * p), 16);
        }
    };

    // the landed X rows of chunk k (raw area of stage s) into the bf16 X
    // stage xs, kV values (one 8- or 16-byte store) at a time: rounded to
    // bf16, zero outside the window, X and the block's columns.  Eight
    // values a store leave too few stores at one n8 tile (32 a chunk for
    // 128 threads): four there
    constexpr int kV = NT == 1 ? 4 : 8;
    const unsigned xlo = (unsigned)reinterpret_cast<uintptr_t>(X);
    auto repack = [&](int k, int s, bf16* xs) {
        const unsigned char* raw =
            smem + s * Tl::kStageBytes + Tl::kBandBytes;
        const int c0 = k * kK;
        int rlo, rhi;
        x_rows(c0, rlo, rhi);
        // low 32 bits of window row 0's first element index (what a row's
        // offset in its first 16-byte unit depends on)
        const unsigned e0 = (unsigned)((start + c0) * B + col0);
        for (int i = tid; i < kK * (kCols / kV); i += kThreads) {
            const int rr = i / (kCols / kV);
            const int c = kV * (i % (kCols / kV));
            float v[kV];
#pragma unroll
            for (int e = 0; e < kV; ++e) v[e] = 0.f;
            if (rr >= rlo && rr < rhi) {
                const unsigned mis =
                    (xlo + (e0 + (unsigned)(rr * B)) * kES) & 15u;
                const TX* xr = reinterpret_cast<const TX*>(
                    raw + rr * kRawPitch + mis);
#pragma unroll
                for (int e = 0; e < kV; ++e)
                    if (c + e < nb) v[e] = as_float(xr[c + e]);
            }
            if constexpr (kV == 8)
                *reinterpret_cast<uint4*>(xs + rr * kXPitch + c) =
                    make_uint4(pack_bf16x2(v[0], v[1]),
                               pack_bf16x2(v[2], v[3]),
                               pack_bf16x2(v[4], v[5]),
                               pack_bf16x2(v[6], v[7]));
            else
                *reinterpret_cast<uint2*>(xs + rr * kXPitch + c) =
                    make_uint2(pack_bf16x2(v[0], v[1]),
                               pack_bf16x2(v[2], v[3]));
        }
    };

    // one chunk's products of this warp's 16 rows: two k16 steps
    auto mma_chunk = [&](float (&acc)[NT][4], const bf16* sb,
                         const bf16* xs) {
#pragma unroll
        for (int ks = 0; ks < kK / 16; ++ks) {
            unsigned a[4];
            ldsm_x4(a, sb + (16 * wm + lane % 16) * kPitch + 16 * ks
                           + 8 * (lane / 16));
            const bf16* xk =
                xs + (16 * ks + lane % 8 + 8 * ((lane / 8) % 2)) * kXPitch;
#pragma unroll
            for (int j = 0; j + 1 < NT; j += 2) {
                unsigned b[4];
                ldsm_x4_trans(b, xk + 8 * j + 8 * (lane / 16));
                mma_bf16(acc[j], a, b[0], b[1]);
                mma_bf16(acc[j + 1], a, b[2], b[3]);
            }
            if constexpr (NT % 2 == 1) {
                unsigned b[2];
                ldsm_x2_trans(b, xk + 8 * (NT - 1));
                mma_bf16(acc[NT - 1], a, b[0], b[1]);
            }
        }
    };

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s) {
        if (s < nk) load_chunk(lo + s, s);
        cp_async_commit();    // empty groups keep the count uniform
    }
    if (nk > 0) {
        cp_async_wait<kTcStages - 2>();   // chunk 0
        __syncthreads();
        repack(lo, 0, xstage);
    }
    for (int i = 0; i < nk; ++i) {
        cp_async_wait<kTcStages - 3>();   // this thread's copies of i + 1
        // everyone's copies of chunk i + 1 landed, X of chunk i repacked,
        // chunk i - 1 consumed (its stage and X stage free)
        __syncthreads();
        const int next = i + kTcStages - 1;
        if (next < nk) load_chunk(lo + next, next % kTcStages);
        cp_async_commit();
        if (i + 1 < nk)
            repack(lo + i + 1, (i + 1) % kTcStages,
                   xstage + ((i + 1) % 2) * kK * kXPitch);
        mma_chunk(acc,
                  reinterpret_cast<const bf16*>(
                      smem + (i % kTcStages) * Tl::kStageBytes),
                  xstage + (i % 2) * kK * kXPitch);
    }

    // accumulator tile j: rows g and g + 8 of the warp's 16, columns
    // 8 j + 2 (lane % 4) + {0, 1}
    const int g = lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * wm + g + 8 * h;
            if (r >= rows) continue;
            TY* yr = Y + ((long long)t * R + r0 + r) * B + col0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int b = 8 * j + 2 * (lane % 4) + e;
                if (b < nb)
                    store(yr + b, (!RECT && coef != nullptr)
                                      ? acc[j][2 * h + e]
                                            * as_float(coef[col0 + b])
                                      : acc[j][2 * h + e]);
            }
        }
    }
}

template <int NT, bool RECT, typename TX, typename TY>
cudaError_t launch_tc(const bf16* band, const int* spans, const int* offs,
                      const TX* X, const TY* coef, TY* Y, int T, int R, int W,
                      int halo, long long n, int B, cudaStream_t stream)
{
    using Tl = TcTile<NT, TX>;
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
        err = cudaFuncSetAttribute(
            tc_band_kernel<NT, RECT, TX, TY>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
        if (err != cudaSuccess) return err;
        raised[dev] = true;
    }
    const dim3 grid(T, (R + kRows - 1) / kRows,
                    (B + Tl::kCols - 1) / Tl::kCols);
    tc_band_kernel<NT, RECT, TX, TY>
        <<<grid, kTcThreads, Tl::kSmem, stream>>>(band, spans, offs, X, coef,
                                                  Y, R, W, halo, n, B);
    return cudaGetLastError();
}

template <bool RECT, typename TX, typename TY>
cudaError_t dispatch_tc(const bf16* band, const int* spans, const int* offs,
                        const TX* X, const TY* coef, TY* Y, int T, int R,
                        int W, int halo, long long n, int B,
                        cudaStream_t stream)
{
    if (T < 1 || R < 1 || R > 65535 * kRows || W < 8 || W % 8 != 0 ||
        B < 1 || (B + kMaxCols - 1) / kMaxCols > 65535 ||
        reinterpret_cast<uintptr_t>(band) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(X) % sizeof(TX) != 0)
        return cudaErrorInvalidValue;
    // n8 tiles per warp: one column block up to 96 columns
#define FEU_LAUNCH_TC(NT)                                                   \
    launch_tc<NT, RECT, TX, TY>(band, spans, offs, X, coef, Y, T, R, W,     \
                                halo, n, B, stream)
    if (B <= 8) return FEU_LAUNCH_TC(1);
    if (B <= 24) return FEU_LAUNCH_TC(3);
    if (B <= 48) return FEU_LAUNCH_TC(6);
    return FEU_LAUNCH_TC(12);
#undef FEU_LAUNCH_TC
}

}  // namespace

extern "C" {

// Kernel A on bf16 operands (tensor cores).  band (T, R, W) with W % 8 == 0,
// X (T*R, B), coef (B,) or null and Y (T*R, B) all bf16; spans as for the
// f32 band.
int feu_band_apply_bf16(const void* band, const void* spans, const void* X,
                        const void* coef, void* Y, int T, int R, int W, int B,
                        void* stream)
{
    if (W % R != 0 || (W / R) % 2 != 1) return (int)cudaErrorInvalidValue;
    const int halo = (W / R - 1) / 2;
    return (int)dispatch_tc<false>(
        static_cast<const bf16*>(band), static_cast<const int*>(spans),
        nullptr, static_cast<const bf16*>(X), static_cast<const bf16*>(coef),
        static_cast<bf16*>(Y), T, R, W, halo, (long long)T * R, B,
        static_cast<cudaStream_t>(stream));
}

// Kernel B on a bf16 band with W % 8 == 0 (tensor cores).  x_bf16 = 0: Xp
// f32, rounded to bf16 as it is staged, Y f32; x_bf16 = 1: Xp and Y bf16.
int feu_rect_band_apply_bf16(const void* band, const void* spans,
                             const void* offs, const void* Xp, void* Y, int T,
                             int R, int W, long long n_cols, int B,
                             int x_bf16, void* stream)
{
    const bf16* bd = static_cast<const bf16*>(band);
    const int* sp = static_cast<const int*>(spans);
    const int* of = static_cast<const int*>(offs);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16)
        return (int)dispatch_tc<true>(bd, sp, of, static_cast<const bf16*>(Xp),
                                      static_cast<const bf16*>(nullptr),
                                      static_cast<bf16*>(Y), T, R, W, 0,
                                      n_cols, B, s);
    return (int)dispatch_tc<true>(bd, sp, of, static_cast<const float*>(Xp),
                                  static_cast<const float*>(nullptr),
                                  static_cast<float*>(Y), T, R, W, 0, n_cols,
                                  B, s);
}

}  // extern "C"
