// Element-block apply for Hopper: kernel C.
//
// Replaces element_apply_pallas (fenics_eff_uptake_tpu/ops/pallas_kernels.py,
// body _kernel) together with the XLA gather before it and the sorted
// segment-sum after it (parallel/sweep.py _Block.apply_batched):
//     Y[d, b] = coef[b] * sum_{(n,i): dofs[n,i] = d} sum_j A[n,i,j] * X[dofs[n,j], b]
// with A (N, nd, nd) shared by all B columns, nd in {2, 3, 6}, f32 or f64,
// in two forms: the full output (every row of Y written, zero where no
// entry lands) and the accumulate form Y[d, b] += coef[b] * (...), which
// reads and writes only the rows the block touches.
//
// The TPU split gather / tiny matmul / scatter into three programs because
// random access inside a TPU kernel serialises.  On the card the chain is
// one pass over row tiles.  A host plan (ops/elemspmv.make_tiles) cuts the
// rows that hold entries into tiles of rows_per_tile consecutive rows;
// their entries, sorted by row, are one contiguous range, cut into chunks
// of at most chunk_slots entries, and for each chunk the plan holds one
// record per distinct element: its index, its nd dofs and the chunk slot
// of each of its nd entries (-1 outside the chunk).  The kernel binds a
// copy of A whose rows A[n, i, :] are in sorted-entry order, so a chunk's
// A rows are one contiguous range.  One thread block owns a tile and a
// block of columns.  It copies the tile's row pointers, and for each chunk
// the element records and the A rows, into shared memory with cp.async,
// then
//   1. takes each element of the chunk once: it gathers the element's nd
//      X values of its column and writes the product
//      a[i,0]*x[0] + ... + a[i,nd-1]*x[nd-1] of each entry in the chunk to
//      shared memory by slot;
//   2. one thread per output sums its row's contiguous slots in sorted
//      order and makes one store (one read, add and store in the
//      accumulate form, four outputs' reads issued together).
// A tile whose entries need several chunks keeps its partial sums in
// shared memory between them.  In the full form, further blocks write the
// plan's rows without entries.  The arithmetic is that of the
// one-thread-per-output design it replaces (the same per-entry chains, the
// same per-row order), and there are no atomics: every output has one
// writer and its summation order is fixed, so two launches agree bit for
// bit.  In the accumulate form the product by coef and the add to Y are
// rounded separately (__fmul_rn, __fadd_rn), as the separate full-output
// apply and add they replace.
//
// What bounds it on an H100: memory traffic, not FLOPs (an f64 nd = 6
// entry is 6 FMAs against 6 gathered X values), and the latency of the
// gathers.  The one-thread-per-output design gathered every element's X
// rows once per entry (nd times); a tile gathers an element once per tile
// it reaches (about 4 times for P2 cells at 64 rows after the
// bandwidth-reducing numbering), and every index and A row it needs for
// that is in shared memory, so a gather waits for one global load.  Each
// block's phases wait on each other, so enough blocks must be resident:
// registers are capped for kMinBlocks blocks per SM.  A boundary block's
// accumulate launch covers only its touched rows (the fine Robin block:
// 2,570 of 102,656 rows), where the full form wrote every row, and its
// plan takes tiles small enough to give every SM work.
//
// The per-sample form (Plan.batch = B > 0) applies one matrix set per
// column, without coef:
//     Y[d, b] = sum_{(n,i): dofs[n,i] = d} sum_j A[b,n,i,j] * X[dofs[n,j], b]
// The JAX package has no Pallas kernel for it (parallel/sweep.py
// _Block.apply_batched unrolls it into elementwise multiply-adds); the
// step-mu Robin blocks of the adv-diff study take it (about 500 facets,
// B = 9).  It runs on the same plan and the same two passes.  A is bound
// with the batch innermost, (N*nd, nd, B) in sorted-entry order, and is
// not staged: pass 1 reads a[k, j, b] from global memory, neighbouring
// threads (columns) at neighbouring addresses, each value used once.  A
// chunk's A rows in shared memory would be B times the shared form's; these
// blocks are a few hundred facets and sit at the launch floor either way.
//
// The bf16 form (Plan.dtype = 2; the Robin blocks of the bf16 cycle): A, X,
// coef and Y are bf16 in memory, and everything between is f32.  The
// gathered X values and the A rows are upcast (exact), an entry's products
// are exact in f32 and summed in f32, the slots and partial sums are f32,
// the product by coef is made in f32, and an output is rounded once, on the
// store; the accumulate form reads the bf16 Y, adds in f32 and rounds once.
// An A row of nd = 3 values is 6 bytes, less than cp.async copies, so those
// rows reach shared memory by plain loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;            // blocks per SM the registers allow
constexpr int kSmemBudget = 96 * 1024;   // dynamic shared memory per block
constexpr int kGapRows = 256;            // rows without entries per block

// Kernel C's plan of one element block; must match elemspmv._PlanStruct.
struct Plan {
    const void* A;        // (N*nd, nd) in the plan's dtype: the rows
                          //   A[n, i, :] in sorted-entry order
    const int* rows;      // (n_rows,) the rows holding entries, ascending
    const int* rptr;      // (n_rows+1,) first sorted entry of each of them
    const int* cptr;      // (n_tiles+1,) first chunk of each tile
    const int* eptr;      // (n_chunks+1,) first element record of each chunk
    const int* meta;      // (n_records, meta_ints) element records
    const int* gaps;      // (n_gaps,) the rows without entries, ascending
    int dtype;            // of A, X, coef and Y: 0 f32, 1 f64, 2 bf16
    int nd, ndofs, n_rows, n_tiles, rows_per_tile, chunk_slots,
        max_chunk, max_elems, max_tile_chunks, n_gaps;
    int batch;            // 0: A shared by the columns; B > 0: per-sample A
                          //   (N*nd, nd, B), bound at exactly B columns
};

// ints per element record: index, nd dofs, nd slots, padded to 16 bytes
__host__ __device__ constexpr int meta_ints(int nd)
{
    return (1 + 2 * nd + 3) / 4 * 4;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// shared memory of a block, in this order: element records, row
// pointers, rows (ints); the chunk's A rows by slot, padded to 16 bytes
// (none in the per-sample form); slots and partial sums for a column block
// of bc.  S is the type in memory (A, X, coef, Y), T the type of the
// arithmetic, the slots and the partial sums: S itself, or f32 for bf16.
template <typename S>
__host__ __device__ long long a_rows_bytes(const Plan& p)
{
    if (p.batch > 0) return 0;
    return ((long long)p.max_chunk * p.nd * sizeof(S) + 15) / 16 * 16;
}

template <typename S> struct Compute { using type = S; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ double up(double v) { return v; }
__device__ __forceinline__ float up(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}

// one rounding to the type in memory
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(double* p, double v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v)
{
    *p = __float2bfloat16_rn(v);
}

template <typename S>
long long smem_bytes(const Plan& p, int bc)
{
    using T = typename Compute<S>::type;
    const long long ints = (long long)p.max_elems * meta_ints(p.nd)
                           + round4(p.rows_per_tile + 1)
                           + round4(p.rows_per_tile);
    long long vals = (long long)p.max_chunk * bc;
    if (p.max_tile_chunks > 1) vals += (long long)p.rows_per_tile * bc;
    return 4 * ints + a_rows_bytes<S>(p) + (long long)sizeof(T) * vals;
}

// the widest copy (16, 8 or 4 bytes) that tiles one A row of nd values;
// 0 where a row is no multiple of 4 bytes (three bf16)
template <typename S, int ND>
__host__ __device__ constexpr int a_piece()
{
    return (ND * sizeof(S)) % 16 == 0 ? 16
           : (ND * sizeof(S)) % 8 == 0 ? 8
           : (ND * sizeof(S)) % 4 == 0 ? 4 : 0;
}

// a product and a sum rounded apart, never contracted into one FMA
__device__ __forceinline__ float mul_rn(float a, float b)
{ return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b)
{ return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b)
{ return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b)
{ return __dadd_rn(a, b); }

__device__ __forceinline__ void copy16_async(void* dst, const void* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
}

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void wait_async()
{
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <typename S, int ND, bool PS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
element_tiles_kernel(const Plan p, const S* __restrict__ X,
                     const S* __restrict__ coef, S* Y, int accumulate, int B,
                     int BC)
{
    using T = typename Compute<S>::type;
    constexpr int M = meta_ints(ND);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* meta_s = reinterpret_cast<int*>(smem_raw);
    int* rp_s = meta_s + p.max_elems * M;
    int* row_s = rp_s + round4(p.rows_per_tile + 1);
    unsigned char* a_raw =
        reinterpret_cast<unsigned char*>(row_s + round4(p.rows_per_tile));
    const S* a_s = reinterpret_cast<const S*>(a_raw);
    T* slots = reinterpret_cast<T*>(a_raw + a_rows_bytes<S>(p));
    T* part = slots + (long long)p.max_chunk * BC;
    const int t = blockIdx.x;
    const int c0 = blockIdx.y * BC;
    const int bc = min(BC, B - c0);
    if (t >= p.n_tiles) {
        // the full output's rows without entries, kGapRows per block: an
        // empty sum, times coef
        if (accumulate) return;
        const int g0 = (t - p.n_tiles) * kGapRows;
        const int n_gap = min(kGapRows, p.n_gaps - g0) * bc;
        for (int o = threadIdx.x; o < n_gap; o += kThreads) {
            const int r = o / bc;
            const int b = c0 + o - r * bc;
            put(Y + (long long)p.gaps[g0 + r] * B + b,
                coef != nullptr ? T(0) * up(coef[b]) : T(0));
        }
        return;
    }
    const int q0 = t * p.rows_per_tile;
    const int nr = min(p.rows_per_tile, p.n_rows - q0);
    const int n_out = nr * bc;
    for (int r = threadIdx.x; r <= nr; r += kThreads)
        copy_async<4>(rp_s + r, p.rptr + q0 + r);
    for (int r = threadIdx.x; r < nr; r += kThreads)
        copy_async<4>(row_s + r, p.rows + q0 + r);
    const int k_tile = p.rptr[q0], k_end = p.rptr[q0 + nr];
    const int ch0 = p.cptr[t], ch1 = p.cptr[t + 1];
    constexpr int kPiece = a_piece<S, ND>();
    const unsigned char* a_src = static_cast<const unsigned char*>(p.A);
    for (int c = ch0; c < ch1; ++c) {
        const int clo = k_tile + (c - ch0) * p.chunk_slots;
        const int chi = min(clo + p.chunk_slots, k_end);
        const int e0 = p.eptr[c];
        const int ne = p.eptr[c + 1] - e0;
        // the chunk's element records, and its entries' A rows: one
        // contiguous range of the sorted rows
        const int* src = p.meta + (long long)e0 * M;
        for (int i = threadIdx.x; i < ne * (M / 4); i += kThreads)
            copy16_async(meta_s + 4 * i, src + 4 * i);
        if constexpr (!PS) {
            const unsigned char* a_chunk =
                a_src + (long long)clo * ND * sizeof(S);
            if constexpr (kPiece > 0) {
                const int n_pieces =
                    (chi - clo) * ND * (int)sizeof(S) / kPiece;
                for (int i = threadIdx.x; i < n_pieces; i += kThreads)
                    copy_async<kPiece>(a_raw + i * kPiece,
                                       a_chunk + i * kPiece);
            } else {
                const S* a_g = reinterpret_cast<const S*>(a_chunk);
                S* a_w = reinterpret_cast<S*>(a_raw);
                for (int i = threadIdx.x; i < (chi - clo) * ND;
                     i += kThreads)
                    a_w[i] = a_g[i];
            }
        }
        wait_async();
        __syncthreads();
        // 1. each element of the chunk once, one thread per column
        for (int q = threadIdx.x; q < ne * bc; q += kThreads) {
            const int el = q / bc;
            const int bl = q - el * bc;
            const int* em = meta_s + el * M;
            T x[ND];
#pragma unroll
            for (int j = 0; j < ND; ++j)
                x[j] = up(X[(long long)em[1 + j] * B + c0 + bl]);
#pragma unroll
            for (int i = 0; i < ND; ++i) {
                const int k = em[1 + ND + i];
                if (k < 0) continue;
                T s;
                if constexpr (PS) {
                    // this column's own row: a[clo + k, :, c0 + bl]
                    const S* a = static_cast<const S*>(p.A)
                                 + (long long)(clo + k) * ND * B + c0 + bl;
                    s = up(a[0]) * x[0];
#pragma unroll
                    for (int j = 1; j < ND; ++j)
                        s += up(a[(long long)j * B]) * x[j];
                } else {
                    const S* a = a_s + k * ND;
                    s = up(a[0]) * x[0];
#pragma unroll
                    for (int j = 1; j < ND; ++j) s += up(a[j]) * x[j];
                }
                slots[k * bc + bl] = s;
            }
        }
        __syncthreads();
        // 2. each output adds its row's slots of the chunk in order
        const bool first = c == ch0, last = c + 1 == ch1;
        for (int o0 = threadIdx.x; o0 < n_out; o0 += 4 * kThreads) {
            T v[4], prev[4];
            long long idx[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int o = o0 + u * kThreads;
                if (o >= n_out) break;
                const int r = o / bc;
                const int bl = o - r * bc;
                const int lo = max(rp_s[r], clo) - clo;
                const int hi = min(rp_s[r + 1], chi) - clo;
                T acc = first ? T(0) : part[o];
                for (int k = lo; k < hi; ++k) acc += slots[k * bc + bl];
                if (!last) {
                    part[o] = acc;
                    continue;
                }
                v[u] = coef != nullptr ? mul_rn(acc, up(coef[c0 + bl])) : acc;
                idx[u] = (long long)row_s[r] * B + c0 + bl;
                if (accumulate) prev[u] = up(Y[idx[u]]);
            }
            if (!last) continue;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (o0 + u * kThreads >= n_out) break;
                put(Y + idx[u], accumulate ? add_rn(prev[u], v[u]) : v[u]);
            }
        }
        __syncthreads();
    }
}

template <typename S, int ND, bool PS>
cudaError_t launch(const Plan& p, const void* X, const void* coef, void* Y,
                   int accumulate, int B, cudaStream_t stream)
{
    // columns per block: the most whose slots fit the shared-memory
    // budget, split evenly
    long long bc = B;
    while (bc > 1 && smem_bytes<S>(p, (int)bc) > kSmemBudget) --bc;
    if (smem_bytes<S>(p, (int)bc) > kSmemBudget) return cudaErrorInvalidValue;
    long long n_cb = (B + bc - 1) / bc;
    bc = (B + n_cb - 1) / n_cb;
    n_cb = (B + bc - 1) / bc;
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            element_tiles_kernel<S, ND, PS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
        if (err != cudaSuccess) return err;
        attr_set = true;
    }
    // the tiles, then (full output only) the blocks of rows without
    // entries; at least one block, so that every call launches
    long long n_blocks = p.n_tiles;
    if (!accumulate) n_blocks += (p.n_gaps + kGapRows - 1) / kGapRows;
    const dim3 grid((unsigned)(n_blocks > 0 ? n_blocks : 1), (unsigned)n_cb);
    element_tiles_kernel<S, ND, PS><<<
        grid, kThreads, (size_t)smem_bytes<S>(p, (int)bc), stream>>>(
        p, static_cast<const S*>(X), static_cast<const S*>(coef),
        static_cast<S*>(Y), accumulate, B, (int)bc);
    return cudaGetLastError();
}

// the shared or the per-sample kernel, as the plan says
template <typename T, int ND>
cudaError_t launch_nd(const Plan& p, const void* X, const void* coef, void* Y,
                      int accumulate, int B, cudaStream_t stream)
{
    if (p.batch > 0)
        return launch<T, ND, true>(p, X, coef, Y, accumulate, B, stream);
    return launch<T, ND, false>(p, X, coef, Y, accumulate, B, stream);
}

template <typename T>
cudaError_t dispatch_nd(const Plan& p, const void* X, const void* coef,
                        void* Y, int accumulate, int B, cudaStream_t stream)
{
    switch (p.nd) {
        case 2: return launch_nd<T, 2>(p, X, coef, Y, accumulate, B, stream);
        case 3: return launch_nd<T, 3>(p, X, coef, Y, accumulate, B, stream);
        case 6: return launch_nd<T, 6>(p, X, coef, Y, accumulate, B, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Kernel C.  plan: one block's Plan (host memory; its arrays on the card),
// in the dtype plan->dtype selects for A, X, coef and Y.  X (n_x, B),
// coef (B,) or null, Y (ndofs, B); all contiguous.  accumulate = 0 writes
// every row of Y; 1 adds into the rows that hold entries and leaves the
// others as they are.  A per-sample plan (plan->batch > 0) takes exactly
// B = plan->batch columns and a null coef.
int feu_element_apply(const void* plan, const void* X, const void* coef,
                      void* Y, int accumulate, int B, void* stream)
{
    const Plan& p = *static_cast<const Plan*>(plan);
    if (B < 1 || p.ndofs < 0 || p.n_tiles < 0 || p.n_gaps < 0
        || p.rows_per_tile < 1 || p.chunk_slots < 1 || p.max_chunk < 0
        || p.max_chunk > p.chunk_slots || p.max_elems < 0
        || p.max_tile_chunks < 0 || p.batch < 0
        || (p.batch > 0 && (B != p.batch || coef != nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p.dtype) {
        case 0: return (int)dispatch_nd<float>(p, X, coef, Y, accumulate, B, s);
        case 1: return (int)dispatch_nd<double>(p, X, coef, Y, accumulate, B, s);
        case 2:
            return (int)dispatch_nd<__nv_bfloat16>(p, X, coef, Y, accumulate,
                                                   B, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Message for an error code returned by any feu_* entry point.
const char* feu_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
