// The f32 forms of kernels A and B for Hopper: persistent CTAs over a work
// list of band blocks, the band streamed by TMA into an mbarrier ring.
//
// Kernel A replaces band_apply_pallas (fenics_eff_uptake_tpu/ops/
// pallas_kernels.py:155, with _band_kernel_factory), f32 branch:
//     Y[t*R + r, b] = coef[b] * sum_{w<W} band[t, r, w] * X[(t - halo)*R + w, b]
// X reads as zero outside [0, n); W = (2*halo + 1)*R.
// Kernel B replaces rect_band_apply_pallas (same file :274), f32 branch:
//     Y[t*R + r, b] = sum_{w<W} band[t, r, w] * Xp[offs[t] + w, b]
// offs is runtime int32 data with no alignment; window rows outside
// [0, n) read as zero.  (The bf16 operand forms are in band_apply.cu.)
//
// What binds.  At B <= 20 each 4-byte band element feeds at most 20 FMAs:
// the band's bytes bind (device-memory bandwidth).  At B = 96 the FMAs do
// (67 TFLOP/s f32 outside the tensor cores).  Less than half of a band
// holds anything: ops/banded.band_spans gives each block of 64 band rows
// (of a tile of R <= 64 rows: the tile) the range [lo, hi) of 32-column
// "sub-boxes" that holds its nonzeros, and only those are streamed.
//
// The design, problem by problem:
//   * Load imbalance and the last wave: the grid is persistent, about
//     (SMs x resident CTAs) CTAs, and walks a work list of blocks (tile,
//     row block; and a column block of 96 above 96 columns).  A bound
//     band (ops/banded.BandKernel) holds the list of its blocks longest
//     span first, one 16-byte record each (block, span, window start);
//     CTA b takes items b, 2G-1-b, 2G+b, ... (G CTAs: a snake over the
//     sorted list), each record loaded one item ahead.  The ring runs on
//     from one item into the next, so no CTA refills a pipeline between
//     its items.
//   * Copies: one producer warp issues every copy, consumer warps only
//     compute (warp specialisation).  A chunk is up to `nsub` sub-boxes of
//     RB rows x 32 columns, each one TMA box copy (cp.async.bulk.tensor.3d)
//     from a CUtensorMap over the (T, R, W) band with the 128-byte swizzle
//     (16-byte unit u of row r lands at unit u ^ (r % 8): the consumers'
//     float4 reads of 8 consecutive rows hit 8 distinct bank groups).  The
//     box zero-fills rows past R and columns past W.  Each chunk lands in a
//     ring stage and completes on the stage's "full" mbarrier (expect_tx);
//     each consumer warp releases the stage on its "empty" mbarrier.
//   * X: a chunk of an item that holds all of B <= 96 columns reads window
//     rows [row0, row0 + 32*ns) x B, one contiguous range of X.  The
//     producer's lanes copy its 16-byte aligned interior by 16-byte
//     cp.async and the (at most 3 + 3) values of its unaligned ends by
//     4-byte ones, zero the rows outside [0, n), and arrive on the stage's
//     barrier once their copies land (cp.async.mbarrier.arrive): no copy
//     waits in the producer, so a chunk costs it no memory latency.  (On
//     an H100 a producer that read the unaligned ends itself waited ~0.7
//     us a chunk, which paced kernel B at B % 4 != 0.)  The X area takes only these
//     generic-proxy writes and the band area only TMA's, so no proxy fence
//     is needed.  The stage keeps the range's global 16-byte phase (value
//     e at offset mis + e), so kernel A (row0 % 4 == 0) and every B % 4 ==
//     0 read X as float4; other B read it by scalar loads (broadcasts
//     within a warp).  Items of more than 96 columns copy their values by
//     4-byte cp.async into rows of 96.
//   * Register tiles: a consumer thread owns TM rows (rg + m * KRG) and TN
//     columns (float4 groups 4 (j CG + cg), or scalars cg + j CG), per 4
//     window columns TM float4 of band and TN / 4 float4 (or TN scalars)
//     of X for 4 TM TN FMAs; B = 96 takes 4 x 8 in six consumer warps (12
//     LDS.128 per 128 FMAs), where the old form ran three.
//   * Tiles sized to the band: a band of R <= 16 rows (the graded mid
//     restriction: R = 8, W = 7168) takes 16-row boxes and chunks of 8
//     sub-boxes (256 columns): a span of 7,168 columns is 28 steps.
//
// The contract (unchanged from the kernels before): IEEE f32 fmaf, no
// tensor cores, no TF32, each output one FMA chain in ascending window
// column over its block's span (sub-boxes ascending, 32 columns each); a
// skipped or zero-filled term is fmaf(0, x, acc) == acc for finite x, so
// the result equals the full-width sum bit for bit and does not depend on
// B, on the chunk width or on the instance.  Kernel A's coef multiplies
// in the store.
//
// Refused (cudaErrorInvalidValue), never worked around: W % 4 != 0, a band
// not 16-byte aligned, X not 4-byte aligned.  A tensor map that does not
// encode returns kErrEncode + its CUresult.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kSub = 32;           // window columns of one sub-box (SPAN_COLS)
constexpr int kSpanRows = 64;      // band rows of one span block (SPAN_ROWS)
constexpr int kMaxCols = 96;       // widest one-pass column block
constexpr int kMaxSub = 8;         // sub-boxes per chunk, at most
constexpr int kMaxStages = 16;
constexpr int kErrEncode = 100000;
constexpr int kXSlack = 8;         // floats past a stage's X values
constexpr unsigned long long kHangNs = 2000000000ull;  // mbarrier wait, 2 s

}  // namespace

// One bound band (ops/banded._BandStruct mirrors it field for field).
struct BandPlan {
    unsigned long long map[16];  // CUtensorMap, written by feu_band_bind
    const float* band;           // (T, R, W) f32
    const int* items;            // (T * nrb, 4) work list (nrb: R / 64 up)
    const int* offs;             // kernel B's window starts (T,), or null
                                 // (kernel A); the work list carries them
    int T, R, W, halo;           // halo: kernel A's
    int rb;                      // box rows: 16 (R <= 16) or 64
};
static_assert(offsetof(BandPlan, band) == 128, "BandPlan layout");
static_assert(offsetof(BandPlan, items) == 136, "BandPlan layout");
static_assert(offsetof(BandPlan, offs) == 144, "BandPlan layout");
static_assert(offsetof(BandPlan, T) == 152, "BandPlan layout");
static_assert(offsetof(BandPlan, R) == 156, "BandPlan layout");
static_assert(offsetof(BandPlan, W) == 160, "BandPlan layout");
static_assert(offsetof(BandPlan, halo) == 164, "BandPlan layout");
static_assert(offsetof(BandPlan, rb) == 168, "BandPlan layout");
static_assert(sizeof(BandPlan) == 176, "BandPlan layout");

namespace {

// what the kernel reads, by value (the map as a __grid_constant__)
struct alignas(64) Params {
    CUtensorMap map;
    const int4* items;
    const float* X;
    const float* coef;
    float* Y;
    long long n;                 // X rows
    int T, R, W, halo, nrb;
    int B, ncb;                  // columns; column blocks of kMaxCols
    int n_virtual;               // T * nrb * ncb
    int nsub, stages, band_sub_bytes;
    int x_stage_bytes;           // a stage's X area (the X areas follow the
                                 // stages' band areas)
    int xvec;                    // X read and Y stored as float4
    int rect;                    // kernel B: windows start at the items'
                                 // offs, not at (t - halo) R
};

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes)
{
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity)
{
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns()
{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Wait for the phase of `parity` to complete.  A wait of seconds is a
// broken ring, never a slow one: it traps (the launch fails) rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity)
{
    if (mbar_try_wait(bar, parity)) return;
    const unsigned long long t0 = global_ns();
    while (!mbar_try_wait(bar, parity))
        if (global_ns() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap* map,
                                        int c0, int c1, int c2, unsigned bar)
{
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(bar)
        : "memory");
}

// 16- and 4-byte copies into shared memory (generic proxy), and an arrive
// on a barrier once all of this thread's earlier ones have landed (the
// barrier's pending count is raised by one until then)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_arrive(unsigned bar)
{
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
                 : "memory");
}

// CTA b's round j of the work: v = j G + b (j even) or j G + G - 1 - b
// (j odd), a snake over the sorted list, and its record {span block
// t * nrb + rb, span lo, span hi, window start of kernel B}: one 16-byte
// load from the bound list (which holds the blocks longest span first)
struct Rec {
    int v;          // -1: no item this round
    int4 w;
};

__device__ __forceinline__ Rec fetch(const Params& p, int j)
{
    Rec r;
    const int G = gridDim.x;
    const int b = blockIdx.x;
    const long long v = (long long)j * G + ((j & 1) ? G - 1 - b : b);
    r.v = v < p.n_virtual ? (int)v : -1;
    r.w = make_int4(0, 0, 0, 0);
    if (r.v < 0) return r;
    r.w = __ldg(p.items + r.v / p.ncb);
    return r;
}

// one work item: block (t, rb), column block from col0 of nb columns, its
// span of nk sub-boxes from lo, and X's row of its window's column 0
struct Item {
    int t, rb, col0, nb, lo, nk;
    long long start;
};

__device__ __forceinline__ Item decode(const Params& p, const Rec& r)
{
    Item it;
    const int base = r.v / p.ncb;
    const int blk = r.w.x;
    it.t = blk / p.nrb;
    it.rb = blk - it.t * p.nrb;
    it.col0 = (r.v - base * p.ncb) * kMaxCols;
    it.nb = min(kMaxCols, p.B - it.col0);
    it.lo = max(r.w.y, 0);
    it.nk = max(0, min(r.w.z, (p.W + kSub - 1) / kSub) - it.lo);
    it.start = p.rect ? (long long)r.w.w : (long long)(it.t - p.halo) * p.R;
    return it;
}

// float offset (0..3) of X's value at element index e within its 16 bytes
__device__ __forceinline__ int phase_of(const float* X, long long e)
{
    return (int)(((reinterpret_cast<uintptr_t>(X) >> 2) + (uint64_t)e) & 3);
}

// The producer warp: every copy of every chunk of this CTA's items.
__device__ void produce(const Params& p, unsigned char* ring, unsigned full0,
                        unsigned empty0)
{
    const int lane = threadIdx.x & 31;
    const bool contiguous = p.ncb == 1;
    int stage = 0;
    unsigned phase = 0;
    Rec nxt = fetch(p, 0);
    for (int j = 0; (long long)j * gridDim.x < p.n_virtual; ++j) {
        const Rec cur = nxt;
        nxt = fetch(p, j + 1);     // the next record's load in flight
        if (cur.v < 0) continue;
        const Item it = decode(p, cur);
        const long long start = it.start;
        for (int s0 = 0; s0 < it.nk; s0 += p.nsub) {
            const int ns = min(p.nsub, it.nk - s0);
            const unsigned full = full0 + 8 * stage;
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            __syncwarp();
            unsigned char* st =
                ring + (size_t)stage * p.nsub * p.band_sub_bytes;
            float* xs = reinterpret_cast<float*>(
                ring + (size_t)p.stages * p.nsub * p.band_sub_bytes
                + (size_t)stage * p.x_stage_bytes);
            const int c0 = (it.lo + s0) * kSub;       // window column
            const int rows = ns * kSub;
            const long long x0 = start + c0;           // X row of window row 0
            const int rlo = (int)min((long long)rows, max(0LL, -x0));
            const int rhi = (int)max((long long)rlo,
                                     min((long long)min(rows, p.W - c0),
                                         p.n - x0));
            if (contiguous) {
                // window rows [rlo, rhi) are X values e in [e0, e1) of the
                // range from X element eg; value e lands at xs[mis + e],
                // keeping its 16-byte phase: 16-byte copies of the aligned
                // interior [ea, eb), 4-byte ones of the ends
                const int B = p.B;
                const long long e0 = (long long)rlo * B, e1 = (long long)rhi * B;
                const long long eg = x0 * B;
                const int mis = phase_of(p.X, eg);
                const long long ea = min(e1, e0 + (4 - (mis + e0) % 4) % 4);
                const long long eb = max(ea, e1 - (mis + e1) % 4);
                const unsigned xs0 = smem_u32(xs + mis);
                const float* xg = p.X + eg;
                for (long long e = ea + 4 * lane; e < eb; e += 128)
                    cp_async16(xs0 + 4 * (unsigned)e, xg + e);
                const long long ends = (ea - e0) + (e1 - eb);
                for (long long i = lane; i < ends; i += 32) {
                    const long long e = i < ea - e0 ? e0 + i
                                                    : eb + (i - (ea - e0));
                    cp_async4(xs0 + 4 * (unsigned)e, xg + e);
                }
                // rows outside X (or past W) read zero
                for (long long e = lane; e < e0; e += 32) xs[mis + e] = 0.f;
                const long long eend = (long long)rows * B;
                for (long long e = e1 + lane; e < eend; e += 32)
                    xs[mis + e] = 0.f;
            } else {
                // rows of kMaxCols values: the item's nb columns
                for (int i = lane; i < rows * kMaxCols; i += 32) {
                    const int rr = i / kMaxCols;
                    const int c = i - rr * kMaxCols;
                    if (rr >= rlo && rr < rhi && c < it.nb)
                        cp_async4(smem_u32(xs + i),
                                  p.X + (x0 + rr) * p.B + it.col0 + c);
                    else
                        xs[i] = 0.f;
                }
            }
            cp_async_arrive(full);
            if (lane == 0) {
                mbar_arrive_tx(full, ns * p.band_sub_bytes);
                for (int s = 0; s < ns; ++s)
                    tma_box(smem_u32(st + s * p.band_sub_bytes), &p.map,
                            c0 + s * kSub, it.rb * kSpanRows, it.t, full);
            } else {
                mbar_arrive(full);
            }
            if (++stage == p.stages) {
                stage = 0;
                phase ^= 1;
            }
        }
    }
}

// One sub-box's FMAs of a thread: RB x 32 band values at sb (swizzled rows
// of 128 bytes), X window rows at xk (pitch xp values).  Per 4 window
// columns (a step) a thread reads TM float4 of band and 4 rows of its X
// values; with D > 0 the reads run D steps ahead of the FMAs, into D + 1
// register slots (the small tiles, whose few chains per thread cannot
// hide a shared-memory load's latency; the loops unroll, so the slots
// are registers).
template <int TM, int TN, int CG, int KRG, bool VEC, int D>
__device__ __forceinline__ void fma_sub(float (&acc)[TM][TN],
                                        const unsigned char* sb,
                                        const float* xk, int xp, int rg,
                                        int cg)
{
    constexpr int kSteps = kSub / 4;
    constexpr int NX = VEC ? TN / 4 : TN;      // X reads per window row
    using XT = typename std::conditional<VEC, float4, float>::type;
    const int sw = rg & 7;
    const unsigned char* rp = sb + rg * 128;
    if constexpr (D == 0) {
        // the wide tiles: X read row by row beside the FMAs (fewer live
        // registers, more CTAs an SM; their chains hide the latency)
#pragma unroll
        for (int k4 = 0; k4 < kSteps; ++k4) {
            float4 a[TM];
#pragma unroll
            for (int m = 0; m < TM; ++m)
                a[m] = *reinterpret_cast<const float4*>(
                    rp + m * KRG * 128 + ((k4 ^ sw) << 4));
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float* xr = xk + (4 * k4 + q) * xp;
                XT x[NX];
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    if constexpr (VEC)
                        x[j] = *reinterpret_cast<const float4*>(
                            xr + 4 * (j * CG + cg));
                    else
                        x[j] = xr[cg + j * CG];
                }
#pragma unroll
                for (int m = 0; m < TM; ++m) {
                    const float av = q == 0   ? a[m].x
                                     : q == 1 ? a[m].y
                                     : q == 2 ? a[m].z
                                              : a[m].w;
#pragma unroll
                    for (int j = 0; j < NX; ++j) {
                        if constexpr (VEC) {
                            acc[m][4 * j] = fmaf(av, x[j].x, acc[m][4 * j]);
                            acc[m][4 * j + 1] =
                                fmaf(av, x[j].y, acc[m][4 * j + 1]);
                            acc[m][4 * j + 2] =
                                fmaf(av, x[j].z, acc[m][4 * j + 2]);
                            acc[m][4 * j + 3] =
                                fmaf(av, x[j].w, acc[m][4 * j + 3]);
                        } else {
                            acc[m][j] = fmaf(av, x[j], acc[m][j]);
                        }
                    }
                }
            }
        }
        return;
    }
    float4 a[D + 1][TM];
    XT x[D + 1][4][NX];
    auto load = [&](int k4, int slot) {
#pragma unroll
        for (int m = 0; m < TM; ++m)
            a[slot][m] = *reinterpret_cast<const float4*>(
                rp + m * KRG * 128 + ((k4 ^ sw) << 4));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float* xr = xk + (4 * k4 + q) * xp;
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                if constexpr (VEC)
                    x[slot][q][j] = *reinterpret_cast<const float4*>(
                        xr + 4 * (j * CG + cg));
                else
                    x[slot][q][j] = xr[cg + j * CG];
            }
        }
    };
#pragma unroll
    for (int k4 = 0; k4 < D; ++k4) load(k4, k4);
#pragma unroll
    for (int k4 = 0; k4 < kSteps; ++k4) {
        const int slot = k4 % (D + 1);
        if (k4 + D < kSteps) load(k4 + D, (k4 + D) % (D + 1));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int m = 0; m < TM; ++m) {
                const float4 am = a[slot][m];
                const float av = q == 0   ? am.x
                                 : q == 1 ? am.y
                                 : q == 2 ? am.z
                                          : am.w;
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    if constexpr (VEC) {
                        const float4 xv = x[slot][q][j];
                        acc[m][4 * j] = fmaf(av, xv.x, acc[m][4 * j]);
                        acc[m][4 * j + 1] = fmaf(av, xv.y, acc[m][4 * j + 1]);
                        acc[m][4 * j + 2] = fmaf(av, xv.z, acc[m][4 * j + 2]);
                        acc[m][4 * j + 3] = fmaf(av, xv.w, acc[m][4 * j + 3]);
                    } else {
                        acc[m][j] = fmaf(av, x[slot][q][j], acc[m][j]);
                    }
                }
            }
        }
    }
}

// The consumer warps: the FMAs of every item, then its stores.
template <int TM, int TN, int CG, int NCW, int D, bool VEC>
__device__ void consume(const Params& p, const unsigned char* ring,
                        unsigned full0, unsigned empty0)
{
    constexpr int KRG = NCW * 32 / CG;
    constexpr int RB = TM * KRG;
    const int tid = threadIdx.x;
    const int rg = tid % KRG;
    const int cg = tid / KRG;
    const int lane = tid & 31;
    const bool contiguous = p.ncb == 1;
    const int xp = contiguous ? p.B : kMaxCols;
    int stage = 0;
    unsigned phase = 0;
    Rec nxt = fetch(p, 0);
    for (int j = 0; (long long)j * gridDim.x < p.n_virtual; ++j) {
        const Rec cur = nxt;
        nxt = fetch(p, j + 1);
        if (cur.v < 0) continue;
        const Item it = decode(p, cur);
        const long long start = it.start;
        float acc[TM][TN];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;
        for (int s0 = 0; s0 < it.nk; s0 += p.nsub) {
            const int ns = min(p.nsub, it.nk - s0);
            mbar_wait(full0 + 8 * stage, phase);
            const unsigned char* st =
                ring + (size_t)stage * p.nsub * p.band_sub_bytes;
            const float* xs = reinterpret_cast<const float*>(
                ring + (size_t)p.stages * p.nsub * p.band_sub_bytes
                + (size_t)stage * p.x_stage_bytes);
            if (contiguous)
                xs += phase_of(p.X, (start + (it.lo + s0) * kSub) * p.B);
            for (int s = 0; s < ns; ++s)
                fma_sub<TM, TN, CG, KRG, VEC, D>(acc, st + s * p.band_sub_bytes,
                                              xs + s * kSub * xp, xp, rg, cg);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * stage);
            if (++stage == p.stages) {
                stage = 0;
                phase ^= 1;
            }
        }
        const int rows = min(RB, p.R - it.rb * kSpanRows);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int r = rg + m * KRG;
            if (r >= rows) continue;
            float* yr = p.Y + ((long long)it.t * p.R + it.rb * kSpanRows + r)
                                  * p.B + it.col0;
            const float* cf = p.coef != nullptr ? p.coef + it.col0 : nullptr;
            if constexpr (VEC) {
                // B % 4 == 0 and Y 16-byte aligned: a float4 a group
#pragma unroll
                for (int j = 0; j < TN / 4; ++j) {
                    const int b = 4 * (j * CG + cg);
                    if (b >= it.nb) continue;
                    float4 y = make_float4(acc[m][4 * j], acc[m][4 * j + 1],
                                           acc[m][4 * j + 2],
                                           acc[m][4 * j + 3]);
                    if (cf != nullptr) {
                        y.x *= cf[b];
                        y.y *= cf[b + 1];
                        y.z *= cf[b + 2];
                        y.w *= cf[b + 3];
                    }
                    *reinterpret_cast<float4*>(yr + b) = y;
                }
            } else {
#pragma unroll
                for (int q = 0; q < TN; ++q) {
                    const int b = cg + q * CG;
                    if (b < it.nb)
                        yr[b] = cf != nullptr ? acc[m][q] * cf[b]
                                              : acc[m][q];
                }
            }
        }
    }
}

template <int TM, int TN, int CG, int NCW, int D>
__global__ void __launch_bounds__(NCW * 32 + 32)
band_f32_kernel(const __grid_constant__ Params p)
{
    extern __shared__ unsigned char smem_raw[];
    // barriers first, then the ring from the next 1024-byte boundary (the
    // 128-byte swizzle's period)
    const unsigned base = smem_u32(smem_raw);
    const unsigned full0 = base;
    const unsigned empty0 = base + 8 * kMaxStages;
    const unsigned ring_u = (base + 16 * kMaxStages + 1023) & ~1023u;
    unsigned char* ring = smem_raw + (ring_u - base);
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.stages; ++s) {
            mbar_init(full0 + 8 * s, 32);
            mbar_init(empty0 + 8 * s, NCW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= NCW * 32) {
        produce(p, ring, full0, empty0);
        return;
    }
    if constexpr (TN % 4 == 0) {
        if (p.xvec) {
            consume<TM, TN, CG, NCW, D, true>(p, ring, full0, empty0);
            return;
        }
    }
    consume<TM, TN, CG, NCW, D, false>(p, ring, full0, empty0);
}

// launch one configuration: smem, occupancy and the persistent grid
template <int TM, int TN, int CG, int NCW, int D>
cudaError_t launch(Params& p, cudaStream_t stream)
{
    constexpr int KRG = NCW * 32 / CG;
    constexpr int RB = TM * KRG;
    static_assert(KRG % 8 == 0 && NCW * 32 % CG == 0, "tile shape");
    auto kern = band_f32_kernel<TM, TN, CG, NCW, D>;
    p.band_sub_bytes = RB * kSub * 4;
    // band areas of 1024-byte multiples (the swizzle's period), then X
    // areas of 16-byte multiples
    p.x_stage_bytes = ((p.nsub * kSub * TN * CG + kXSlack) * 4 + 15) & ~15;
    const int smem = 16 * kMaxStages + 1024
                     + p.stages * (p.nsub * p.band_sub_bytes + p.x_stage_bytes);
    static int raised[64] = {};
    static int sms[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
        int optin = 0;
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
        if (err != cudaSuccess) return err;
        err = cudaDeviceGetAttribute(&sms[dev],
                                     cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        raised[dev] = optin;
    }
    if (smem > raised[dev]) return cudaErrorInvalidValue;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                        NCW * 32 + 32, smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    const long long slots = (long long)occ * sms[dev];
    const int grid = (int)(p.n_virtual < slots ? p.n_virtual : slots);
    kern<<<grid, NCW * 32 + 32, smem, stream>>>(p);
    return cudaGetLastError();
}

// The register tile of a band of R rows at b columns per item: <TM rows,
// TN columns per thread, CG column groups, NCW consumer warps, D steps of
// read-ahead>.  Every tile of 64-row boxes spans 64 rows (TM x NCW x 32 /
// CG); B = 1, 2, 3 (the per-run models, Stokes and transport cycles) get
// tiles of exactly their columns, as X rows of B % 4 != 0 values are read
// value by value; B = 96 takes 4 x 8 in six warps.
cudaError_t dispatch(Params& p, cudaStream_t stream)
{
    const int b = p.B < kMaxCols ? p.B : kMaxCols;
    if (p.R <= 16) {                       // 16-row boxes
        if (b <= 4) return launch<2, 1, 4, 1, 7>(p, stream);
        return launch<2, 8, 12, 3, 0>(p, stream);
    }
    if (b == 1) return launch<1, 1, 1, 2, 3>(p, stream);
    if (b == 2) return launch<1, 2, 1, 2, 3>(p, stream);
    if (b == 3) return launch<1, 3, 1, 2, 3>(p, stream);
    if (b == 4) return launch<1, 4, 1, 2, 3>(p, stream);
    if (b <= 12) return launch<2, 6, 2, 2, 2>(p, stream);
    if (b <= 24) return launch<4, 4, 6, 3, 0>(p, stream);
    if (b <= 48) return launch<2, 8, 6, 6, 0>(p, stream);
    return launch<4, 8, 12, 6, 0>(p, stream);
}

PFN_cuTensorMapEncodeTiled_v12000 encoder()
{
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
    return fn;
}

}  // namespace

extern "C" {

// Check a bound band and encode its tensor map into plan->map: the band
// as (W, R, T) f32, boxes of 32 x rb x 1, the 128-byte swizzle, zero fill.
int feu_band_bind(BandPlan* plan)
{
    const BandPlan& b = *plan;
    if (b.T < 1 || b.R < 1 || b.W < 4 || b.W % 4 != 0 ||
        (b.rb != 16 && b.rb != 64) || (b.rb == 16) != (b.R <= 16) ||
        b.band == nullptr || b.items == nullptr ||
        reinterpret_cast<uintptr_t>(b.band) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(b.items) % 16 != 0 ||
        (long long)b.T * ((b.R + kSpanRows - 1) / kSpanRows) > (1LL << 30))
        return (int)cudaErrorInvalidValue;
    auto encode = encoder();
    if (encode == nullptr) return (int)cudaErrorInvalidDeviceFunction;
    CUtensorMap map;
    const cuuint64_t dims[3] = {(cuuint64_t)b.W, (cuuint64_t)b.R,
                                (cuuint64_t)b.T};
    const cuuint64_t strides[2] = {(cuuint64_t)b.W * 4,
                                   (cuuint64_t)b.W * b.R * 4};
    const cuuint32_t box[3] = {(cuuint32_t)kSub, (cuuint32_t)b.rb, 1};
    const cuuint32_t es[3] = {1, 1, 1};
    const CUresult res = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
        const_cast<float*>(b.band), dims, strides, box, es,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        // 128-byte L2 promotion: 256 bytes fetched a short span's
        // neighbouring sub-box for nothing (on an H100 the narrow
        // prolongations ran 6-7% slower with it)
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return kErrEncode + (int)res;
    static_assert(sizeof(map) == sizeof(plan->map), "tensor map size");
    memcpy(plan->map, &map, sizeof(map));
    return 0;
}

// Kernel A (plan->offs null) or B on a bound band: X (n, B) f32, coef (B,)
// f32 or null (kernel A only), Y (T*R, B) f32; nsub sub-boxes per chunk
// (1..8), a ring of `stages` chunks (2..16).
int feu_band_launch(const BandPlan* plan, const void* X, long long n,
                    const void* coef, void* Y, int B, int nsub, int stages,
                    void* stream)
{
    const BandPlan& b = *plan;
    if (B < 1 || n < 0 || nsub < 1 || nsub > kMaxSub || stages < 2 ||
        stages > kMaxStages || X == nullptr || Y == nullptr ||
        reinterpret_cast<uintptr_t>(X) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(Y) % 4 != 0 ||
        (b.offs != nullptr && coef != nullptr))
        return (int)cudaErrorInvalidValue;
    static_assert(alignof(Params) == 64, "Params alignment");
    Params p;
    memcpy(&p.map, b.map, sizeof(p.map));
    p.items = reinterpret_cast<const int4*>(b.items);
    p.rect = b.offs != nullptr;
    p.X = static_cast<const float*>(X);
    p.coef = static_cast<const float*>(coef);
    p.Y = static_cast<float*>(Y);
    p.n = n;
    p.T = b.T;
    p.R = b.R;
    p.W = b.W;
    p.halo = b.halo;
    p.nrb = (b.R + kSpanRows - 1) / kSpanRows;
    p.B = B;
    p.ncb = (B + kMaxCols - 1) / kMaxCols;
    const long long nv = (long long)b.T * p.nrb * p.ncb;
    if (nv > (1LL << 30)) return (int)cudaErrorInvalidValue;
    p.n_virtual = (int)nv;
    p.nsub = nsub;
    p.stages = stages;
    // float4 X reads and Y stores: B % 4 == 0, Y 16-byte aligned, and X
    // rows at a 16-byte phase of 0 (X 16-byte aligned) or the producer's
    // rows of 96
    p.xvec = B % 4 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0 &&
             (p.ncb > 1 || reinterpret_cast<uintptr_t>(X) % 16 == 0);
    return (int)dispatch(p, static_cast<cudaStream_t>(stream));
}

// sizeof(BandPlan) and the offsets of its fields after the map, for the
// binding's layout check
int feu_band_plan_layout(long long* out, int n)
{
    const long long v[] = {(long long)sizeof(BandPlan),
                           (long long)offsetof(BandPlan, band),
                           (long long)offsetof(BandPlan, items),
                           (long long)offsetof(BandPlan, offs),
                           (long long)offsetof(BandPlan, T),
                           (long long)offsetof(BandPlan, R),
                           (long long)offsetof(BandPlan, W),
                           (long long)offsetof(BandPlan, halo),
                           (long long)offsetof(BandPlan, rb)};
    const int m = (int)(sizeof(v) / sizeof(v[0]));
    for (int i = 0; i < n && i < m; ++i) out[i] = v[i];
    return m;
}

}  // extern "C"
