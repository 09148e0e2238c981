// One-thread-per-output variant of kernel C, timed against the row-tile
// kernel of fenics_eff_uptake_tpu_torch/ops/csrc/element_apply.cu by
// scripts/band_kernel_ab.py --rows-variant.  The port never calls it.
//
// It is the design the row tiles replaced (one thread per output (d, b)
// walks row d's sorted entries through perm / rowptr and gathers each
// entry's element X values itself), with two things of the tile kernel:
// the accumulate form launches over a list of rows (the block's touched
// rows) only, and rounds the product by coef and the add to Y apart:
//     Y[d, b] (+)= coef[b] * sum_{(n,i): dofs[n,i] = d} sum_j A[n,i,j] * X[dofs[n,j], b]
// Same per-entry chains and per-row order as the tile kernel, so the two
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b)
{ return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b)
{ return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b)
{ return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b)
{ return __dadd_rn(a, b); }

template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ A, const int* __restrict__ dofs,
            const int* __restrict__ perm, const int* __restrict__ rowptr,
            const int* __restrict__ rows, const T* __restrict__ X,
            const T* __restrict__ coef, T* Y, int n_rows, int B,
            int accumulate)
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)n_rows * B) return;
    const int q = (int)(idx / B);
    const int b = (int)(idx - (long long)q * B);
    const int d = rows != nullptr ? rows[q] : q;
    T acc = T(0);
    const int k1 = rowptr[d + 1];
    for (int k = rowptr[d]; k < k1; ++k) {
        const int p = perm[k];
        const int e = p / ND;
        const int i = p - e * ND;
        const T* a = A + ((long long)e * ND + i) * ND;
        const int* de = dofs + (long long)e * ND;
        T s = a[0] * X[(long long)de[0] * B + b];
#pragma unroll
        for (int j = 1; j < ND; ++j) s += a[j] * X[(long long)de[j] * B + b];
        acc += s;
    }
    const long long o = (long long)d * B + b;
    const T v = coef != nullptr ? mul_rn(acc, coef[b]) : acc;
    Y[o] = accumulate ? add_rn(Y[o], v) : v;
}

template <typename T, int ND>
cudaError_t launch(const void* A, const void* dofs, const void* perm,
                   const void* rowptr, const void* rows, const void* X,
                   const void* coef, void* Y, int n_rows, int B,
                   int accumulate, cudaStream_t stream)
{
    const long long blocks = ((long long)n_rows * B + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (blocks == 0) return cudaSuccess;
    rows_kernel<T, ND><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const int*>(dofs),
        static_cast<const int*>(perm), static_cast<const int*>(rowptr),
        static_cast<const int*>(rows), static_cast<const T*>(X),
        static_cast<const T*>(coef), static_cast<T*>(Y), n_rows, B,
        accumulate);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_nd(int nd, const void* A, const void* dofs,
                        const void* perm, const void* rowptr,
                        const void* rows, const void* X, const void* coef,
                        void* Y, int n_rows, int B, int accumulate,
                        cudaStream_t s)
{
    switch (nd) {
        case 2: return launch<T, 2>(A, dofs, perm, rowptr, rows, X, coef, Y, n_rows, B, accumulate, s);
        case 3: return launch<T, 3>(A, dofs, perm, rowptr, rows, X, coef, Y, n_rows, B, accumulate, s);
        case 6: return launch<T, 6>(A, dofs, perm, rowptr, rows, X, coef, Y, n_rows, B, accumulate, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// is_f64 selects double or float for A, X, coef and Y.  A (N, nd, nd),
// dofs (N, nd), perm (N*nd,), rowptr (ndofs+1,) int32; rows (n_rows,)
// int32, or null for rows 0 .. n_rows-1; X (n_x, B), coef (B,) or null,
// Y (ndofs, B).  accumulate = 1 adds into Y's listed rows.
int feu_rows_variant(int is_f64, int nd, const void* A, const void* dofs,
                     const void* perm, const void* rowptr, const void* rows,
                     const void* X, const void* coef, void* Y, int n_rows,
                     int B, int accumulate, void* stream)
{
    if (B < 1 || n_rows < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_f64)
        return (int)dispatch_nd<double>(nd, A, dofs, perm, rowptr, rows, X,
                                        coef, Y, n_rows, B, accumulate, s);
    return (int)dispatch_nd<float>(nd, A, dofs, perm, rowptr, rows, X, coef,
                                   Y, n_rows, B, accumulate, s);
}

}  // extern "C"
