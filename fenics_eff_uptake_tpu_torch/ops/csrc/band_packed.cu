// Kernel A's packed f32 form for Hopper: the band's nonzeros alone.
//
// Kernel A (band_f32.cu, replacing band_apply_pallas of
// fenics_eff_uptake_tpu/ops/pallas_kernels.py:155, f32 branch) computes
//     Y[t*R + r, b] = coef[b] * sum_{w<W} band[t, r, w] * X[(t - halo)*R + w, b]
// with X read as zero outside [0, n).  Its span form streams each 64-row
// block's column span, and an assembled operator's spans are mostly zeros:
// a row of P2 holds ~12 nonzeros, while the graded w0.4/d2.0 band (W =
// 2,816) streams ~1,150 columns a row, 873 MB an apply for ~9 MB of values.
// This form reads the nonzeros alone (ops/banded.band_pack, PackedBand):
//
//   * Layout (sliced ELL): rows in slices of 32 (one warp), each padded to
//     its longest row, slot-major (slot j of the slice's row i at
//     offs[s] + 32 j + i), so a warp's load of one slot is one coalesced
//     run of 128 bytes of values and 64 of uint16 window columns.  A row's
//     entries are its nonzeros in ascending window column, then padding
//     (value 0 at the row's own column).
//   * What binds: the values and columns stream once from device memory;
//     X is gathered, entry by entry (B values of one row), and stays in
//     L2 (2.25 MB in the graded cell at B = 3, 8.5 MB at B = 20).  A
//     padding slot loads no X.
//   * One thread owns one row and a column tile of TB <= 32 columns, its
//     sums in registers: B <= 4 takes a tile of exactly B columns, wider
//     B tiles of up to 32, so B = 96 runs three tiles (three warps a
//     slice) and every accumulator stays in a register.  The slot loop
//     runs U slots at once (their loads in flight together): 8 at one
//     column, 4 up to 4, 2 above; CTAs of 4 warps.
//   * Measured on an H100 (700 W): X staged in shared memory (each tile's
//     window of X copied in first) lost to the gather, 0.025 against
//     0.013 ms on the graded band (735, 256, 2,816) at B = 3, and 0.109
//     against 0.023 ms on the mu sweep's fine K (401, 256, 1,280) at
//     B = 20.  No other variant tried (U halved or doubled, CTAs of 8
//     warps) was faster by more than 4% in any case; U = 1 was 41%
//     slower at B = 1.
//
// The contract is the span form's: IEEE f32 fmaf, each output one chain
// over the row's entries in ascending window column from +0, coef
// multiplied in the store.  The span form's chain differs only by zero
// terms, fmaf(0, x, acc) == acc for finite x (X rows outside [0, n) read
// as zero in both), so the two give the same Y bit for bit.
//
// Refused (cudaErrorInvalidValue): a null or misaligned pointer, B < 1,
// n < 1, no slices.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

// One bound packed band (ops/banded._PackedStruct mirrors it).
struct PackedPlan {
    const float* vals;  // (slots,) f32
    const void* cols;   // (slots,) window columns: uint16, or int32 (wide)
    const int* offs;    // (ns + 1,) slice s's slots [offs[s], offs[s + 1])
    long long n;        // rows of the band, of X and of Y: T * R
    int ns, R, halo;    // slices; rows of a tile; kernel A's halo
    int wide;           // int32 columns (W > 65,535)
};
static_assert(offsetof(PackedPlan, vals) == 0, "PackedPlan layout");
static_assert(offsetof(PackedPlan, cols) == 8, "PackedPlan layout");
static_assert(offsetof(PackedPlan, offs) == 16, "PackedPlan layout");
static_assert(offsetof(PackedPlan, n) == 24, "PackedPlan layout");
static_assert(offsetof(PackedPlan, ns) == 32, "PackedPlan layout");
static_assert(offsetof(PackedPlan, R) == 36, "PackedPlan layout");
static_assert(offsetof(PackedPlan, halo) == 40, "PackedPlan layout");
static_assert(offsetof(PackedPlan, wide) == 44, "PackedPlan layout");
static_assert(sizeof(PackedPlan) == 48, "PackedPlan layout");

namespace {

constexpr int kSlice = 32;         // rows of one slice (banded.PACK_ROWS)
constexpr int kWarps = 4;          // warps of a CTA

struct Params {
    PackedPlan b;
    const float* X;
    const float* coef;
    float* Y;
    int B, ncb;                    // columns; column tiles
};

template <int TB, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
band_f32_kernel_packed(const __grid_constant__ Params p)
{
    constexpr int U = TB == 1 ? 8 : TB <= 4 ? 4 : 2;   // slots in flight
    constexpr int NX = VEC ? TB / 4 : TB;      // X loads an entry
    using XT = typename std::conditional<VEC, float4, float>::type;
    const int lane = threadIdx.x & 31;
    const long long wg = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (wg >= (long long)p.b.ns * p.ncb) return;
    const int s = (int)(wg / p.ncb);
    const int col0 = (int)(wg - (long long)s * p.ncb) * TB;
    const int nb = min(TB, p.B - col0);
    const long long row = (long long)s * kSlice + lane;
    const long long base = (row / p.b.R - p.b.halo) * p.b.R;
    const long long n = p.b.n;
    const int B = p.B;
    const float* __restrict__ vals = p.b.vals;
    const unsigned short* __restrict__ c16 =
        static_cast<const unsigned short*>(p.b.cols);
    const int* __restrict__ c32 = static_cast<const int*>(p.b.cols);
    const float* __restrict__ X = p.X + col0;
    const bool wide = p.b.wide != 0;

    float acc[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = 0.f;

    // entry q: its value and X row; a padding slot (value 0) and a row
    // outside X load nothing and add fmaf(v, 0, acc)
    auto gather = [&](int q, float& v, XT (&x)[NX]) {
        v = __ldg(vals + q);
        const long long xr = base + (wide ? __ldg(c32 + q) : (int)__ldg(c16 + q));
        const bool live =
            v != 0.f && (unsigned long long)xr < (unsigned long long)n;
        const float* xp = X + xr * B;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
            if constexpr (VEC) {
                x[j] = live && 4 * j < nb
                           ? __ldg(reinterpret_cast<const float4*>(xp) + j)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                x[j] = live && j < nb ? __ldg(xp + j) : 0.f;
            }
        }
    };
    auto fma_entry = [&](float v, const XT (&x)[NX]) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
            if constexpr (VEC) {
                acc[4 * j] = fmaf(v, x[j].x, acc[4 * j]);
                acc[4 * j + 1] = fmaf(v, x[j].y, acc[4 * j + 1]);
                acc[4 * j + 2] = fmaf(v, x[j].z, acc[4 * j + 2]);
                acc[4 * j + 3] = fmaf(v, x[j].w, acc[4 * j + 3]);
            } else {
                acc[j] = fmaf(v, x[j], acc[j]);
            }
        }
    };

    const int o1 = __ldg(p.b.offs + s + 1);
    int o = __ldg(p.b.offs + s) + lane;
    for (; o + (U - 1) * kSlice < o1; o += U * kSlice) {
        float v[U];
        XT x[U][NX];
#pragma unroll
        for (int u = 0; u < U; ++u) gather(o + u * kSlice, v[u], x[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) fma_entry(v[u], x[u]);
    }
    for (; o < o1; o += kSlice) {
        float v;
        XT x[NX];
        gather(o, v, x);
        fma_entry(v, x);
    }

    if (row >= n) return;
    float* yr = p.Y + row * B + col0;
    const float* cf = p.coef != nullptr ? p.coef + col0 : nullptr;
    auto out = [&](int b) {
        return cf != nullptr ? __fmul_rn(acc[b], cf[b]) : acc[b];
    };
    if constexpr (VEC) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
            if (4 * j >= nb) continue;
            *reinterpret_cast<float4*>(yr + 4 * j) =
                make_float4(out(4 * j), out(4 * j + 1), out(4 * j + 2),
                            out(4 * j + 3));
        }
    } else {
#pragma unroll
        for (int b = 0; b < TB; ++b)
            if (b < nb) yr[b] = out(b);
    }
}

template <int TB, bool VEC>
cudaError_t launch(const Params& p, cudaStream_t stream)
{
    const long long warps = (long long)p.b.ns * p.ncb;
    const long long grid = (warps + kWarps - 1) / kWarps;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    band_f32_kernel_packed<TB, VEC>
        <<<(unsigned)grid, kWarps * 32, 0, stream>>>(p);
    return cudaGetLastError();
}

template <int TB>
cudaError_t launch_tile(Params& p, bool vec, cudaStream_t stream)
{
    p.ncb = (p.B + TB - 1) / TB;
    if constexpr (TB % 4 == 0) {
        if (vec) return launch<TB, true>(p, stream);
    }
    return launch<TB, false>(p, stream);
}

// the column tile of B columns: B itself up to 4, then the next of 8, 12,
// 16, 20, 24, and 32 above (in column tiles of 32)
cudaError_t dispatch(Params& p, bool vec, cudaStream_t stream)
{
    switch (p.B) {
    case 1: return launch_tile<1>(p, vec, stream);
    case 2: return launch_tile<2>(p, vec, stream);
    case 3: return launch_tile<3>(p, vec, stream);
    case 4: return launch_tile<4>(p, vec, stream);
    default: break;
    }
    if (p.B <= 8) return launch_tile<8>(p, vec, stream);
    if (p.B <= 12) return launch_tile<12>(p, vec, stream);
    if (p.B <= 16) return launch_tile<16>(p, vec, stream);
    if (p.B <= 20) return launch_tile<20>(p, vec, stream);
    if (p.B <= 24) return launch_tile<24>(p, vec, stream);
    return launch_tile<32>(p, vec, stream);
}

}  // namespace

extern "C" {

// Kernel A on a bound packed band: X (n, B) f32, coef (B,) f32
// or null, Y (n, B) f32.
int feu_band_packed_launch(const PackedPlan* plan, const void* X,
                           const void* coef, void* Y, int B, void* stream)
{
    const PackedPlan& b = *plan;
    if (B < 1 || b.n < 1 || b.ns < 1 || b.R < 1 || b.halo < 0 ||
        b.vals == nullptr || b.cols == nullptr || b.offs == nullptr ||
        X == nullptr || Y == nullptr ||
        reinterpret_cast<uintptr_t>(b.vals) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(b.cols) % (b.wide ? 4 : 2) != 0 ||
        reinterpret_cast<uintptr_t>(b.offs) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(X) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(Y) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(coef) % 4 != 0)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.b = b;
    p.X = static_cast<const float*>(X);
    p.coef = static_cast<const float*>(coef);
    p.Y = static_cast<float*>(Y);
    p.B = B;
    p.ncb = 1;
    // float4 X reads and Y stores: B % 4 == 0, X and Y 16-byte aligned
    const bool vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Y) % 16 == 0;
    return (int)dispatch(p, vec, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
