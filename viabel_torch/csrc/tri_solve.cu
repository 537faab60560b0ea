// The generic triangular solve: X = T^{-1} B for a lower or upper T.
//
// Replaces: viabel_tpu/ops/trsm.py:_vmem_solve_kernel (vmem_solve_triangular,
// the pl.pallas_call at trsm.py:276).
//
// Callers: FullRankGaussian.log_density (the forward solve L^{-1}(x - mu)^T
// behind vi_diagnostics' log weights), its adjoint L^{-T} G (the KSD null
// scores), and the closed-form KL, all through families._tri_solve.
//
// Bound on the H100: operations. A d x d triangle against S right-hand sides
// is d^2 S FLOP, over (d^2 + 2 d S) elements of traffic; at vi_diagnostics'
// (1000, 100000) f32 that is 9.99e10 FLOP (1.49 ms at 67 TFLOP/s) against
// 802 MB (0.24 ms at 3.35 TB/s). At S <= 16 the solve is one block and the
// chain of d dependent steps sets the time instead (latency).
//
// Design (simple and right first): a right-looking substitution with the
// right-hand side in registers. One block of 256 threads owns a tile of
// kCols columns of B; thread t owns rows t, t + 256, ... (RPT rows, a
// template parameter from d) and keeps their kCols values in registers.
// Step i: the owner of row i scales it by 1/T_ii (that row is now x_i) and
// publishes x_i through a two-slot shared buffer; after one barrier every
// thread subtracts T[k, i] x_i from each of its unsolved rows k. The slot
// written at step i is read again only at step i + 2, after the barrier of
// step i + 1, so one barrier per step suffices. Each thread keeps its part
// of the next steps' columns (diagonal included) in flight with cp.async
// into shared memory, and skips, with a block-uniform branch, the 256-row
// chunks that are already solved.
//
// T is read column-major (element (r, c) at T[c * d + r]): step i reads
// column i, so neighbouring threads read neighbouring addresses. The
// wrapper passes T.mT.contiguous() for a row-major T, and T itself (no copy)
// when it solves with T's transpose, as the adjoint does; the left-looking
// form would read rows instead but costs a block reduction per step. B and
// X are read and written through their strides, so the (d, n) transposed
// view that log_density passes is read with coalesced loads as it is, and X
// takes B's layout. The other triangle of T is never read. There is no
// padding: rows past d and columns past S are masked. The TPU kernel's
// Newton-inverted diagonal blocks and bf16 early iterations have no
// counterpart; everything runs in the input type. A blocked substitution
// with tensor-core products is later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 1536;  // the TPU kernel's range (trsm.py:_VMEM_MAX_DIM)

// kCols columns of B per block; kAhead columns of T in flight per thread
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int kCols = 16, kAhead = 4; };
template <> struct Tile<double> { static constexpr int kCols = 8, kAhead = 2; };

// Two blocks per SM where the registers allow (float, d <= 1024): a block
// waits at its barrier once per step, and the other block fills that wait.
template <typename T, int RPT>
constexpr int min_blocks() { return sizeof(T) == 4 && RPT <= 4 ? 2 : 1; }

template <typename T, int RPT, bool LOWER>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, RPT>()))
tri_solve(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ X,
          int d, int64_t S, int64_t bs_r, int64_t bs_c, int64_t xs_r,
          int64_t xs_c) {
  constexpr int C = Tile<T>::kCols;
  constexpr int P = Tile<T>::kAhead;
  __shared__ __align__(16) T xs[2][C];
  const int tid = threadIdx.x;
  const int64_t c0 = int64_t(blockIdx.x) * C;
  const int cols = int(S - c0 < C ? S - c0 : C);

  T b[RPT][C];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = r * kThreads + tid;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      b[r][c] = (k < d && c < cols) ? B[k * bs_r + (c0 + c) * bs_c] : T(0);
    }
  }

  // ring[p][r][tid] = T[k, i] for this thread's rows k from the diagonal on
  // (k >= i for LOWER, k <= i otherwise): the owner's diagonal and the rows
  // that step i updates. Slot p holds the column of every step s with
  // s % P == p, copied asynchronously (cp.async) as soon as step s - P is
  // done, so each column has P - 1 steps to arrive. A plain load would not
  // do: the barrier of each step waits for the thread's outstanding loads,
  // which put the L2 latency back on the chain of dependent steps. Each
  // thread copies and reads only its own elements, so waiting for its own
  // copies is enough.
  __shared__ T ring[P][RPT][kThreads];
  auto load_column = [&](int step, int p) {
    if (step < d) {
      const int i = LOWER ? step : d - 1 - step;
      const T* col = A + int64_t(i) * d;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int k = r * kThreads + tid;
        if (LOWER ? (k >= i && k < d) : (k <= i)) {
          __pipeline_memcpy_async(&ring[p][r][tid], col + k, sizeof(T));
        }
      }
    }
    __pipeline_commit();  // one group per step, empty past the end
  };
#pragma unroll
  for (int p = 0; p < P; ++p) load_column(p, p);

  for (int s0 = 0; s0 < d; s0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int step = s0 + p;
      if (step >= d) break;  // block-uniform
      const int i = LOWER ? step : d - 1 - step;
      __pipeline_wait_prior(P - 1);  // this step's column has arrived
      T a[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) a[r] = ring[p][r][tid];
      T* slot = xs[step & 1];
      if ((i % kThreads) == tid) {
        const int ri = i / kThreads;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if (r == ri) {
            const T inv_diag = T(1) / a[r];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              b[r][c] *= inv_diag;
              slot[c] = b[r][c];
            }
          }
        }
      }
      __syncthreads();
      T xi[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xi[c] = slot[c];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        // rows r * 256 ... r * 256 + 255: a block-uniform skip once all are solved
        if (LOWER ? (r * kThreads + kThreads - 1 > i) : (r * kThreads < i)) {
          const int k = r * kThreads + tid;
          if (LOWER ? (k > i && k < d) : (k < i)) {
#pragma unroll
            for (int c = 0; c < C; ++c) b[r][c] -= a[r] * xi[c];
          }
        }
      }
      load_column(step + P, p);
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = r * kThreads + tid;
    if (k < d) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < cols) X[k * xs_r + (c0 + c) * xs_c] = b[r][c];
      }
    }
  }
}

template <typename T, int RPT>
void launch_rpt(const T* A, const T* B, T* X, int d, int64_t S, int64_t bs_r,
                int64_t bs_c, int64_t xs_r, int64_t xs_c, bool lower,
                cudaStream_t stream) {
  constexpr int C = Tile<T>::kCols;
  const dim3 grid(unsigned((S + C - 1) / C));
  if (lower) {
    tri_solve<T, RPT, true><<<grid, kThreads, 0, stream>>>(
        A, B, X, d, S, bs_r, bs_c, xs_r, xs_c);
  } else {
    tri_solve<T, RPT, false><<<grid, kThreads, 0, stream>>>(
        A, B, X, d, S, bs_r, bs_c, xs_r, xs_c);
  }
}

template <typename T>
int launch(const T* A, const T* B, T* X, int64_t d, int64_t S, int64_t bs_r,
           int64_t bs_c, int64_t xs_r, int64_t xs_c, int lower,
           cudaStream_t stream) {
  constexpr int C = Tile<T>::kCols;
  // grid x takes up to 2^31 - 1 blocks
  if (d <= 0 || d > kMaxDim || S <= 0 || (S + C - 1) / C > INT32_MAX) {
    return int(cudaErrorInvalidValue);
  }
  const int n = int(d);
  switch ((n + kThreads - 1) / kThreads) {
    case 1: launch_rpt<T, 1>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lower, stream); break;
    case 2: launch_rpt<T, 2>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lower, stream); break;
    case 3: launch_rpt<T, 3>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lower, stream); break;
    case 4: launch_rpt<T, 4>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lower, stream); break;
    case 5: launch_rpt<T, 5>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lower, stream); break;
    default: launch_rpt<T, 6>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lower, stream); break;
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int viabel_tri_solve_f32(const float* A, const float* B, float* X,
                                    int64_t d, int64_t S, int64_t bs_r,
                                    int64_t bs_c, int64_t xs_r, int64_t xs_c,
                                    int lower, cudaStream_t stream) {
  return launch<float>(A, B, X, d, S, bs_r, bs_c, xs_r, xs_c, lower, stream);
}

extern "C" int viabel_tri_solve_f64(const double* A, const double* B, double* X,
                                    int64_t d, int64_t S, int64_t bs_r,
                                    int64_t bs_c, int64_t xs_r, int64_t xs_c,
                                    int lower, cudaStream_t stream) {
  return launch<double>(A, B, X, d, S, bs_r, bs_c, xs_r, xs_c, lower, stream);
}
