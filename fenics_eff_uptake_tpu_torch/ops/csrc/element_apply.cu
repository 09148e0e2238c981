// Fused element-block apply for Hopper: kernel C.
//
// Replaces element_apply_pallas (fenics_eff_uptake_tpu/ops/pallas_kernels.py,
// body _kernel) together with the XLA gather before it and the sorted
// segment-sum after it (parallel/sweep.py _Block.apply_batched):
//     Y[d, b] = coef[b] * sum_{(n,i): dofs[n,i] = d} sum_j A[n,i,j] * X[dofs[n,j], b]
// with A (N, nd, nd) shared by all B columns, nd in {2, 3, 6}, f32 or f64.
//
// The TPU split gather / tiny matmul / scatter into three programs because
// random access inside a TPU kernel serialises.  On the card the whole
// chain is one pass: one thread per output (d, b) walks the sorted segment
// of row d (perm / rowptr, built once on the host), gathers X inside the
// kernel and sums in registers.  No atomics: every output has one writer
// and the summation order is fixed, so the f64 defect residuals are the
// same from run to run.
//
// What bounds it on an H100: memory traffic of the gathers, not FLOPs (an
// f64 nd = 6 entry is 6 FMAs against ~6 random X reads).  Threads of one
// row are adjacent in b, so each X gather is a contiguous B-wide segment
// and the A / dofs / perm reads are broadcast across those threads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
element_apply_kernel(const T* __restrict__ A, const int* __restrict__ dofs,
                     const int* __restrict__ perm,
                     const int* __restrict__ rowptr, const T* __restrict__ X,
                     const T* __restrict__ coef, T* __restrict__ Y, int ndofs,
                     int B)
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)ndofs * B) return;
    const int d = (int)(idx / B);
    const int b = (int)(idx - (long long)d * B);
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
    Y[idx] = (coef != nullptr) ? acc * coef[b] : acc;
}

template <typename T, int ND>
cudaError_t launch(const void* A, const void* dofs, const void* perm,
                   const void* rowptr, const void* X, const void* coef,
                   void* Y, int ndofs, int B, cudaStream_t stream)
{
    const long long total = (long long)ndofs * B;
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (blocks == 0) return cudaSuccess;
    element_apply_kernel<T, ND><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const int*>(dofs),
        static_cast<const int*>(perm), static_cast<const int*>(rowptr),
        static_cast<const T*>(X), static_cast<const T*>(coef),
        static_cast<T*>(Y), ndofs, B);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_nd(int nd, const void* A, const void* dofs,
                        const void* perm, const void* rowptr, const void* X,
                        const void* coef, void* Y, int ndofs, int B,
                        cudaStream_t stream)
{
    switch (nd) {
        case 2: return launch<T, 2>(A, dofs, perm, rowptr, X, coef, Y, ndofs, B, stream);
        case 3: return launch<T, 3>(A, dofs, perm, rowptr, X, coef, Y, ndofs, B, stream);
        case 6: return launch<T, 6>(A, dofs, perm, rowptr, X, coef, Y, ndofs, B, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Kernel C.  is_f64 selects double (1) or float (0) for A, X, coef and Y.
// A (N, nd, nd), dofs (N, nd) int32, perm (N*nd,) int32, rowptr (ndofs+1,)
// int32, X (n_x, B), coef (B,) or null, Y (ndofs, B); all contiguous.
int feu_element_apply(int is_f64, int nd, const void* A, const void* dofs,
                      const void* perm, const void* rowptr, const void* X,
                      const void* coef, void* Y, int ndofs, int B,
                      void* stream)
{
    if (B < 1 || ndofs < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_f64)
        return (int)dispatch_nd<double>(nd, A, dofs, perm, rowptr, X, coef,
                                        Y, ndofs, B, s);
    return (int)dispatch_nd<float>(nd, A, dofs, perm, rowptr, X, coef, Y,
                                   ndofs, B, s);
}

// Message for an error code returned by any feu_* entry point.
const char* feu_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
