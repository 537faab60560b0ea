// The sticking-the-landing score solve: X = L(theta)^{-T} B.
//
// Replaces: viabel_tpu/ops/trsm.py:_stl_solve_kernel (stl_transpose_solve,
// the pl.pallas_call at trsm.py:242).
//
// L = tril(theta, -1) + diag(exp(diag theta)) is formed on the fly from the
// raw (d, d) Cholesky parameter block: the diagonal is exp(theta_ii), the
// strict lower part is read verbatim, and the upper triangle is never read.
// L is never stored in device memory.
//
// Bound on the H100: latency, not bandwidth or arithmetic. Backward
// substitution is d dependent steps; at the d=1000 flagship with S=10
// columns the whole solve is 10 MFLOP over a 4 MB f32 theta that sits in
// the 50 MB L2 after the first touch. What costs is the chain of d steps,
// each a block-wide barrier plus one L2 read of a theta row.
//
// Design (simple and right first): a right-looking backward substitution.
// For i = d-1 ... 0: x_i = b_i * exp(-theta_ii), then b_k -= theta[i, k] * x_i
// for every k < i. Row i of theta is contiguous, so the update's reads are
// coalesced. One block per tile of B's columns keeps the tile's b/x in
// shared memory (column-major, so consecutive k fall in consecutive banks);
// a wider B gives more blocks, not wider ones. Every thread computes the
// tile's x_i in registers from shared memory, so one barrier per step
// suffices: step i reads only row i, which step i+1 finished before its
// barrier, and writes only rows k < i. There are no low-precision steps
// (the TPU kernel's bf16-input Newton inverses have no counterpart here).
// A blocked substitution, register tiles over several columns and TMA/wgmma
// are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;       // columns of B per block
constexpr int kMaxDim = 1536;   // the TPU kernel's range (trsm.py:_VMEM_MAX_DIM)

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
stl_solve(const T* __restrict__ theta, const T* __restrict__ B,
          T* __restrict__ X, int d, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);  // sb[c * d + k]
  const int c0 = blockIdx.x * kTile;
  const int cols = min(kTile, S - c0);

  for (int idx = threadIdx.x; idx < d * cols; idx += kThreads) {
    const int k = idx / cols, c = idx % cols;
    sb[c * d + k] = B[int64_t(k) * S + c0 + c];
  }
  __syncthreads();

  for (int i = d - 1; i >= 0; --i) {
    const T* row = theta + int64_t(i) * d;
    const T inv_diag = exp_t(-row[i]);
    T xi[kTile];
#pragma unroll
    for (int c = 0; c < kTile; ++c) xi[c] = c < cols ? sb[c * d + i] * inv_diag : T(0);
    if (threadIdx.x == 0) {
      for (int c = 0; c < cols; ++c) X[int64_t(i) * S + c0 + c] = xi[c];
    }
    for (int k = threadIdx.x; k < i; k += kThreads) {
      const T l_ik = row[k];
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        if (c < cols) sb[c * d + k] -= l_ik * xi[c];
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* theta, const T* B, T* X, int64_t d, int64_t S,
           cudaStream_t stream) {
  if (d <= 0 || d > kMaxDim || S <= 0 || S > int64_t(65535) * kTile) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = size_t(d) * kTile * sizeof(T);
  // The opt-in above the 48 KB default is a per-device attribute, so it is
  // set on every launch (a cheap host call) rather than cached once.
  const cudaError_t err = cudaFuncSetAttribute(
      stl_solve<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((S + kTile - 1) / kTile));
  stl_solve<T><<<grid, kThreads, smem, stream>>>(theta, B, X, int(d), int(S));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int viabel_stl_transpose_solve_f32(const float* theta, const float* B,
                                              float* X, int64_t d, int64_t S,
                                              cudaStream_t stream) {
  return launch<float>(theta, B, X, d, S, stream);
}

extern "C" int viabel_stl_transpose_solve_f64(const double* theta, const double* B,
                                              double* X, int64_t d, int64_t S,
                                              cudaStream_t stream) {
  return launch<double>(theta, B, X, d, S, stream);
}
