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
// Bound on the H100: the chain of dependent steps, not bytes or FLOP. At the
// d=1000 flagship with S=10 columns the solve is 10 MFLOP over 2 MB of theta
// (0.6 us at 3.35 TB/s), but backward substitution is d = 1000 dependent
// steps. A substitution that pays a block barrier and an L2 read on each
// step takes about 2 ms there.
//
// Design: a blocked backward substitution over panels of 32 rows, from the
// bottom, so that the chain is 32 panels long with two block barriers each.
// With U = L^T, panel P = [p0, p0 + 32) needs only U[P, P], the transposed
// diagonal block of theta.
//  - The diagonal solve runs in one warp per column of the tile, without
//    block barriers: lane l holds b[p0 + l], and each of the 32 steps is one
//    __shfl_sync of the step's value and one FMA per lane against the
//    diagonal block, staged in shared memory beforehand with each row i
//    already scaled by 1/U_ii = exp(-theta_ii).
//  - The rank-32 update b[k] -= sum_{i in P} theta[i, k] x_i for k < p0 runs
//    in registers: thread t owns rows t, t + 512, ... of the tile's
//    right-hand side, issues a batch of loads of theta[i, k] before its FMAs
//    (row i of theta is contiguous in k, so a warp's loads are coalesced),
//    and reads the solved x_P broadcast from shared memory. Meanwhile it
//    stages the next panel's diagonal block, and the warp that owns the next
//    panel's rows hands them to the diagonal warps.
// A block owns C columns of B (2, or 8 in float32 past 1024 rows; see
// launch), so a wider B gives more blocks, not wider ones. Panels are aligned to 32 rows
// from the top: the bottom panel, solved first, is the ragged one when
// d % 32 != 0, and its missing rows are zero in every buffer, as are the
// columns past S. Nothing is padded in memory. B and X are read and written
// through their strides, so the transposed view of the (S, d) draws that
// the STL caller passes is read with coalesced loads as it is. Everything
// runs in the input type: the TPU kernel's bf16-input Newton inverses have
// no counterpart. Later work: one column tile's update spread across
// several blocks, TMA, and tensor-core products for the update.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kPanel = 32;                              // rows per panel: one per lane
constexpr int kStage = kPanel * kPanel / kThreads;      // diagonal-block elements per thread
constexpr int kMaxDim = 1536;  // the TPU kernel's range (trsm.py:_VMEM_MAX_DIM)
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T, int C>
struct __align__(16) Shared {
  T m[kPanel][kPanel];  // m[i][l] = theta[p0+i, p0+l] exp(-theta[p0+i, p0+i]) for l < i, else 0
  T inv[kPanel];        // exp(-theta_ii)
  T b[C][kPanel];       // the panel's right-hand side, a column per diagonal warp
  T x[kPanel][C];       // the solved panel, a row per broadcast read of the update
};

// Loads this thread's elements of the diagonal block at rows and columns
// [p0, p0 + 32): element e = s * kThreads + tid is (i, l) = (e / 32, e % 32).
template <typename T>
__device__ __forceinline__ void stage_load(const T* __restrict__ theta, int d, int p0,
                                           T (&a)[kStage], T (&g)[kStage]) {
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int e = s * kThreads + threadIdx.x;
    const int i = e / kPanel, l = e % kPanel, row = p0 + i;
    const T* r = theta + int64_t(row) * d;
    a[s] = (row < d && l < i) ? r[p0 + l] : T(0);
    g[s] = row < d ? r[row] : T(0);
  }
}

template <typename T, int C>
__device__ __forceinline__ void stage_store(Shared<T, C>& sh, const T (&a)[kStage],
                                            const T (&g)[kStage]) {
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int e = s * kThreads + threadIdx.x;
    const int i = e / kPanel, l = e % kPanel;
    const T inv = exp_t(-g[s]);
    sh.m[i][l] = l < i ? a[s] * inv : T(0);
    if (l == i) sh.inv[i] = inv;
  }
}

// The threads that own rows [p0, p0 + 32) (one warp) hand them to the
// diagonal warps.
template <typename T, int C, int RPT>
__device__ __forceinline__ void hand_over(Shared<T, C>& sh, const T (&b)[RPT][C], int p0) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = r * kThreads + threadIdx.x;
    if (k >= p0 && k < p0 + kPanel) {
#pragma unroll
      for (int c = 0; c < C; ++c) sh.b[c][k - p0] = b[r][c];
    }
  }
}

// C values from a 16-byte-aligned row of shared memory, in 16-byte loads
// where C allows.
template <typename T, int C>
__device__ __forceinline__ void load_row(const T* src, T (&x)[C]) {
  if constexpr (sizeof(T) == 4 && C % 4 == 0) {
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(src)[j];
      x[4 * j] = v.x; x[4 * j + 1] = v.y; x[4 * j + 2] = v.z; x[4 * j + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 8 && C % 2 == 0) {
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const double2 v = reinterpret_cast<const double2*>(src)[j];
      x[2 * j] = v.x; x[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = src[c];
  }
}

template <typename T, int C, int RPT>
__global__ void __launch_bounds__(kThreads)
stl_solve(const T* __restrict__ theta, const T* __restrict__ B, T* __restrict__ X,
          int d, int64_t S, int64_t bs_r, int64_t bs_c, int64_t xs_r, int64_t xs_c) {
  constexpr int NB = int(128 / sizeof(T));  // theta loads in flight: 32 registers' worth
  __shared__ Shared<T, C> sh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t c0 = int64_t(blockIdx.x) * C;
  const int cols = int(S - c0 < C ? S - c0 : C);

  // b[r][c]: row r * kThreads + tid, column c0 + c; zero past d and past S
  T b[RPT][C];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = r * kThreads + tid;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      b[r][c] = (k < d && c < cols) ? B[k * bs_r + (c0 + c) * bs_c] : T(0);
    }
  }

  int p0 = (d - 1) / kPanel * kPanel;  // the bottom panel, rows [p0, d)
  {
    T a[kStage], g[kStage];
    stage_load(theta, d, p0, a, g);
    stage_store(sh, a, g);
    hand_over(sh, b, p0);
  }
  for (;;) {
    __syncthreads();  // the panel's rows and diagonal block are staged
    if (warp < C) {
      // lane l holds row p0 + l of column `warp`; step i subtracts
      // U[p0 + l, p0 + i] x_i from the rows above it
      T v = sh.b[warp][lane];
#pragma unroll
      for (int i = kPanel - 1; i > 0; --i) {
        const T vi = __shfl_sync(kFullMask, v, i);
        v -= sh.m[i][lane] * vi;
      }
      sh.x[lane][warp] = v * sh.inv[lane];
    }
    __syncthreads();  // x_P is in shared memory

    const int pn = p0 - kPanel;  // the next panel: a full one
    T a[kStage], g[kStage];
    if (pn >= 0) stage_load(theta, d, pn, a, g);  // stored after the update
    const int w = min(kPanel, d - p0);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = r * kThreads + tid;
      if (r * kThreads < p0 && k < p0) {
        // theta[p0 + i, k] for i in the panel, from the panel's last row
        // up, so that each b[k] takes its terms in the order of i, last
        // first, as an unblocked substitution would
        const T* col = theta + int64_t(p0) * d + k;
#pragma unroll
        for (int h = kPanel - NB; h >= 0; h -= NB) {
          T t[NB];
#pragma unroll
          for (int j = NB - 1; j >= 0; --j) t[j] = h + j < w ? col[(h + j) * d] : T(0);
#pragma unroll
          for (int j = NB - 1; j >= 0; --j) {
            T x[C];
            load_row<T, C>(sh.x[h + j], x);
#pragma unroll
            for (int c = 0; c < C; ++c) b[r][c] -= t[j] * x[c];
          }
        }
      } else if (k >= p0 && k < p0 + kPanel) {
        // this thread's row is in the panel: it keeps its solution
        load_row<T, C>(sh.x[k - p0], b[r]);
      }
    }
    if (pn < 0) break;
    stage_store(sh, a, g);
    hand_over(sh, b, pn);
    p0 = pn;
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

template <typename T, int C, int RPT>
int launch_tile(const T* theta, const T* B, T* X, int d, int64_t S, int64_t bs_r,
                int64_t bs_c, int64_t xs_r, int64_t xs_c, cudaStream_t stream) {
  if ((S + C - 1) / C > INT32_MAX) return int(cudaErrorInvalidValue);  // grid x
  const dim3 grid(unsigned((S + C - 1) / C));
  stl_solve<T, C, RPT><<<grid, kThreads, 0, stream>>>(theta, B, X, d, S, bs_r, bs_c, xs_r,
                                                       xs_c);
  return int(cudaGetLastError());
}

// Two columns of B per block: a block's time is its chain of panels plus
// FMAs in proportion to its columns, so at the S the STL caller sends (10 to
// 400) narrow tiles in more blocks finish first. In float32 past 1024 rows
// (three rows a thread) a block takes 8 columns, which measured faster there
// on an H100 (PERF.md, PR 4).
template <typename T>
int launch(const T* theta, const T* B, T* X, int64_t d, int64_t S, int64_t bs_r,
           int64_t bs_c, int64_t xs_r, int64_t xs_c, cudaStream_t stream) {
  if (d <= 0 || d > kMaxDim || S <= 0) return int(cudaErrorInvalidValue);
  const int n = int(d);
  if (n <= kThreads) {
    return launch_tile<T, 2, 1>(theta, B, X, n, S, bs_r, bs_c, xs_r, xs_c, stream);
  }
  if (n <= 2 * kThreads) {
    return launch_tile<T, 2, 2>(theta, B, X, n, S, bs_r, bs_c, xs_r, xs_c, stream);
  }
  constexpr int wide = sizeof(T) == 4 ? 8 : 2;
  return launch_tile<T, wide, 3>(theta, B, X, n, S, bs_r, bs_c, xs_r, xs_c, stream);
}

}  // namespace

extern "C" int viabel_stl_transpose_solve_f32(const float* theta, const float* B, float* X,
                                              int64_t d, int64_t S, int64_t bs_r,
                                              int64_t bs_c, int64_t xs_r, int64_t xs_c,
                                              cudaStream_t stream) {
  return launch<float>(theta, B, X, d, S, bs_r, bs_c, xs_r, xs_c, stream);
}

extern "C" int viabel_stl_transpose_solve_f64(const double* theta, const double* B,
                                              double* X, int64_t d, int64_t S, int64_t bs_r,
                                              int64_t bs_c, int64_t xs_r, int64_t xs_c,
                                              cudaStream_t stream) {
  return launch<double>(theta, B, X, d, S, bs_r, bs_c, xs_r, xs_c, stream);
}
