// The generic triangular solve: X = T^{-1} B for a lower or upper T.
//
// Replaces: viabel_tpu/ops/trsm.py:_vmem_solve_kernel (vmem_solve_triangular,
// the pl.pallas_call at trsm.py:276).
//
// Callers: FullRankGaussian.log_density (the forward solve L^{-1}(x - mu)^T
// behind vi_diagnostics' log weights), its adjoint L^{-T} G (the KSD null
// scores), and the closed-form KL, all through families._tri_solve.
//
// Bound on the H100: operations at the front door, the chain of dependent
// steps at its narrow shapes. A d x d triangle against S right-hand sides is
// d^2 S FLOP over (d^2 / 2 + 2 d S) elements of traffic: at vi_diagnostics'
// (1000, 100000) f32 that is 1e11 FLOP (1.49 ms at 67 TFLOP/s) against 0.8 GB
// (0.24 ms at 3.35 TB/s). At S = 10 it is 1e7 FLOP, and the d = 1000
// dependent steps of the substitution set the time instead.
//
// Design: the blocked substitution of stl_solve.cu (the STL solve), copied,
// with the diagonal read as it stands and a direction as a template
// parameter. Panels of 32 rows, so that the chain is 32 panels long with two
// block barriers each:
//  - upper T (backward): panels from the bottom. Panel P = [p0, p0 + 32)
//    needs T[P, P]; the rank-32 update goes to the rows k < p0 above it.
//  - lower T (forward): the mirror. Panels from the top; the update goes to
//    the rows k >= p0 + 32 below it.
// The diagonal solve runs in one warp per column of the tile, without block
// barriers: lane l holds b[p0 + l], and each of the 31 steps is one
// __shfl_sync of the step's value and one FMA per lane against the diagonal
// block, staged in shared memory beforehand with each column i already scaled
// by 1/T_ii. The rank-32 update b[k] -= sum_{i in P} T[k, i] x_i runs in
// registers: thread t owns rows t, t + 512, ... of the tile's right-hand
// side, issues a batch of loads of T[k, i] before its FMAs, and reads the
// solved x_P broadcast from shared memory. Unlike stl_solve.cu, it reads
// each row of x_P once for all of its rows that the panel updates, and skips
// the chunks of 512 rows that are done, with a branch the whole block takes:
// at 16 columns and two rows a thread a 16-byte shared-memory read feeds 8
// FMAs, not 4. Meanwhile it stages the next panel's diagonal block, and the
// warp that owns the next panel's rows hands them to the diagonal warps.
//
// T is read column-major (element (r, c) at A[c * d + r]; the wrapper passes
// T.mT.contiguous(), which for the adjoint's T^T is T itself, no copy), so
// the update's loads of column i at rows k are coalesced in k, in both
// directions; the upper case reads the very addresses stl_solve.cu reads in
// theta. The other triangle of T is never read. A block owns C columns of B:
// narrow tiles where the chain sets the time, wide ones where the update's
// FMAs and its reads of the triangle from L2 do (see launch), one 512-thread
// block an SM either way. Panels are aligned to 32 rows from the top, so the
// ragged panel is the first one solved when T is upper and the last when it
// is lower; its missing rows are zero in every buffer (with a unit
// diagonal), as are the columns past S.
// Nothing is padded in memory. B and X are read and written through their
// strides, so the (d, n) transposed view that log_density passes is read
// with coalesced loads as it is, and X takes B's layout. Everything runs in
// the input type: the TPU kernel's Newton-inverted diagonal blocks and bf16
// early iterations have no counterpart. Later work: tensor-core products for
// the update, and one column tile's update spread across several blocks.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kPanel = 32;                              // rows per panel: one per lane
constexpr int kStage = kPanel * kPanel / kThreads;      // diagonal-block elements per thread
constexpr int kMaxDim = 1536;  // the TPU kernel's range (trsm.py:_VMEM_MAX_DIM)
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWideCols = 16;   // the wide tile's columns (float32, d <= 1024)
constexpr int64_t kWideFrom = 512;  // the wide tile serves S above this

template <typename T, int C>
struct __align__(16) Shared {
  T m[kPanel][kPanel];  // m[i][l] = T[p0+l, p0+i] / T[p0+i, p0+i] below (lower) or
                        // above (upper) the diagonal, else 0
  T inv[kPanel];        // 1 / T_ii
  T b[C][kPanel];       // the panel's right-hand side, a column per diagonal warp
  T x[kPanel][C];       // the solved panel, a row per broadcast read of the update
};

// Loads this thread's elements of the diagonal block at rows and columns
// [p0, p0 + 32): element e = s * kThreads + tid is (i, l) = (e / 32, e % 32),
// T[p0 + l, p0 + i] in a and T_ii in g (1 past d).
template <typename T, bool LOWER>
__device__ __forceinline__ void stage_load(const T* __restrict__ A, int d, int p0,
                                           T (&a)[kStage], T (&g)[kStage]) {
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int e = s * kThreads + threadIdx.x;
    const int i = e / kPanel, l = e % kPanel, row = p0 + i;
    const T* r = A + int64_t(row) * d;  // column p0 + i of T
    a[s] = (LOWER ? (l > i && p0 + l < d) : (row < d && l < i)) ? r[p0 + l] : T(0);
    g[s] = row < d ? r[row] : T(1);
  }
}

template <typename T, int C, bool LOWER>
__device__ __forceinline__ void stage_store(Shared<T, C>& sh, const T (&a)[kStage],
                                            const T (&g)[kStage]) {
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int e = s * kThreads + threadIdx.x;
    const int i = e / kPanel, l = e % kPanel;
    const T inv = T(1) / g[s];
    sh.m[i][l] = (LOWER ? l > i : l < i) ? a[s] * inv : T(0);
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

// The rank-32 update b[k] -= sum_{i in P} T[k, p0 + i] x_i for this thread's
// rows k = r * kThreads + tid with r in [R0, R1): those below the panel
// (lower) or above it (upper), the others masked. Each row of x_P is read
// from shared memory once for all R1 - R0 rows, and the loads of T (column
// p0 + i at rows k, coalesced in k) are issued a batch at a time before the
// FMAs. Each b[k] takes its terms in the order of the solve, as an unblocked
// substitution would: i ascending (lower), or from the panel's last row up.
template <typename T, int C, int RPT, int R0, int R1, bool LOWER>
__device__ __forceinline__ void update(T (&b)[RPT][C], const Shared<T, C>& sh,
                                       const T* __restrict__ A, int d, int p0) {
  constexpr int R = R1 - R0;
  // T loads in flight per thread: 32 registers' worth, 16 in the wide tile,
  // whose accumulators take 32 registers at two rows a thread
  constexpr int kLoads = C >= kWideCols ? 16 : int(128 / sizeof(T));
  constexpr int NB = kLoads / (R == 1 ? 1 : R == 2 ? 2 : 4);
  // x_P in 16-byte pieces where C allows
  constexpr int V = (C * sizeof(T)) % 16 == 0 ? int(16 / sizeof(T)) : 1;
  const int w = min(kPanel, d - p0);
  const T* col[R];
  bool on[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = (R0 + r) * kThreads + threadIdx.x;
    on[r] = LOWER ? (k >= p0 + kPanel && k < d) : k < p0;
    col[r] = A + int64_t(p0) * d + k;
  }
  // a loop, not unrolled, so that one batch's offsets (h + j) * d are live
  // at a time
#pragma unroll 1
  for (int s = 0; s < kPanel / NB; ++s) {
    const int h = LOWER ? s * NB : kPanel - NB - s * NB;
    T t[R][NB];
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      const int j = LOWER ? jj : NB - 1 - jj;
#pragma unroll
      for (int r = 0; r < R; ++r) t[r][j] = on[r] && h + j < w ? col[r][(h + j) * d] : T(0);
    }
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      const int j = LOWER ? jj : NB - 1 - jj;
#pragma unroll
      for (int q = 0; q < C; q += V) {
        T x[V];
        load_row<T, V>(sh.x[h + j] + q, x);
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < V; ++c) b[R0 + r][q + c] -= t[r][j] * x[c];
        }
      }
    }
  }
}

// One block an SM, up to 128 registers a thread, and no spills. Held to 64
// registers (two blocks an SM), the wide tile spilled 64-212 bytes in every
// form tried; it was faster at (1000, 100000) and (1000, 4096) lower, and
// slower at (1000, 1000) and (1000, 4096) upper (PERF.md).
template <typename T, int C, int RPT, bool LOWER>
__global__ void __launch_bounds__(kThreads, 1)
tri_solve(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ X,
          int d, int64_t S, int64_t bs_r, int64_t bs_c, int64_t xs_r, int64_t xs_c) {
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

  // the first panel: the top one (lower), or the bottom one, rows [p0, d) (upper)
  int p0 = LOWER ? 0 : (d - 1) / kPanel * kPanel;
  {
    T a[kStage], g[kStage];
    stage_load<T, LOWER>(A, d, p0, a, g);
    stage_store<T, C, LOWER>(sh, a, g);
    hand_over(sh, b, p0);
  }
  for (;;) {
    __syncthreads();  // the panel's rows and diagonal block are staged
    if (warp < C) {
      // lane l holds row p0 + l of column `warp`; step i subtracts
      // T[p0 + l, p0 + i] x_i from the rows after it in the solve's order
      T v = sh.b[warp][lane];
      if constexpr (LOWER) {
#pragma unroll
        for (int i = 0; i < kPanel - 1; ++i) {
          const T vi = __shfl_sync(kFullMask, v, i);
          v -= sh.m[i][lane] * vi;
        }
      } else {
#pragma unroll
        for (int i = kPanel - 1; i > 0; --i) {
          const T vi = __shfl_sync(kFullMask, v, i);
          v -= sh.m[i][lane] * vi;
        }
      }
      sh.x[lane][warp] = v * sh.inv[lane];
    }
    __syncthreads();  // x_P is in shared memory

    const int pn = LOWER ? p0 + kPanel : p0 - kPanel;  // the next panel
    const bool more = LOWER ? pn < d : pn >= 0;
    T a[kStage], g[kStage];
    if (more) stage_load<T, LOWER>(A, d, pn, a, g);  // stored after the update
    // the chunks of kThreads rows that hold rows to update: from the first
    // one below the panel on (lower), up to the last one above it (upper)
    if constexpr (LOWER) {
      if (p0 + kPanel < d) {
        const int lo = (p0 + kPanel) / kThreads;
        if (lo == 0) {
          update<T, C, RPT, 0, RPT, LOWER>(b, sh, A, d, p0);
        } else if constexpr (RPT >= 2) {
          if (lo == 1) {
            update<T, C, RPT, 1, RPT, LOWER>(b, sh, A, d, p0);
          } else if constexpr (RPT >= 3) {
            update<T, C, RPT, 2, RPT, LOWER>(b, sh, A, d, p0);
          }
        }
      }
    } else {
      const int hi = (p0 + kThreads - 1) / kThreads;
      if (hi == RPT) {
        update<T, C, RPT, 0, RPT, LOWER>(b, sh, A, d, p0);
      } else if constexpr (RPT >= 2) {
        if (hi == 1) {
          update<T, C, RPT, 0, 1, LOWER>(b, sh, A, d, p0);
        } else if constexpr (RPT >= 3) {
          if (hi == 2) update<T, C, RPT, 0, 2, LOWER>(b, sh, A, d, p0);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      // this thread's row is in the panel: it keeps its solution
      const int k = r * kThreads + tid;
      if (k >= p0 && k < p0 + kPanel) load_row<T, C>(sh.x[k - p0], b[r]);
    }
    if (!more) break;
    stage_store<T, C, LOWER>(sh, a, g);
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
int launch_tile(const T* A, const T* B, T* X, int d, int64_t S, int64_t bs_r,
                int64_t bs_c, int64_t xs_r, int64_t xs_c, bool lower, cudaStream_t stream) {
  if ((S + C - 1) / C > INT32_MAX) return int(cudaErrorInvalidValue);  // grid x
  const dim3 grid(unsigned((S + C - 1) / C));
  if (lower) {
    tri_solve<T, C, RPT, true><<<grid, kThreads, 0, stream>>>(A, B, X, d, S, bs_r, bs_c,
                                                              xs_r, xs_c);
  } else {
    tri_solve<T, C, RPT, false><<<grid, kThreads, 0, stream>>>(A, B, X, d, S, bs_r, bs_c,
                                                               xs_r, xs_c);
  }
  return int(cudaGetLastError());
}

// The column tile. Narrow, as in stl_solve.cu: 2 columns, or 8 in float32
// past 1024 rows (three rows a thread). A narrow block's time is its chain of
// 32 panels, so while the narrow tiles fit the card at once, more blocks of
// fewer columns finish first. Wide, in float32 up to 1024 rows, for S above
// kWideFrom: every block reads the whole triangle from L2 (2 MB at d = 1000),
// so at the front door's 100,000 columns 2-column tiles read 100 GB, and
// 16-column ones 12.5 GB. Measured by tools/time_tri_solve.py, f32, CUDA
// events, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md):
//  - wide against narrow only (this build): (1000, 1000) 0.2385 against
//    0.4447 ms, (1000, 4096) 0.4503 / 0.4558 against 1.5740 / 1.4360 ms
//    (lower / upper), (1000, 100000) 9.3114 against 33.1002 ms; at
//    (1000, 10) both take the narrow tile, 0.16-0.17 ms.
//  - 16 against 8 columns, both then at two blocks an SM: (1000, 100000)
//    8.1316 against 9.2964 ms, (1000, 4096) lower 0.4192 against 0.5005 ms
//    and upper 0.5879 against 0.4834 ms. The 8-column tile was removed: it
//    lost at the front door's shape, the one that takes the most time.
template <typename T>
int launch(const T* A, const T* B, T* X, int64_t d, int64_t S, int64_t bs_r,
           int64_t bs_c, int64_t xs_r, int64_t xs_c, int lower, cudaStream_t stream) {
  if (d <= 0 || d > kMaxDim || S <= 0) return int(cudaErrorInvalidValue);
  const int n = int(d);
  const bool lo = lower != 0;
  if constexpr (sizeof(T) == 4) {
    if (S > kWideFrom && n <= 2 * kThreads) {
      return n <= kThreads
          ? launch_tile<T, kWideCols, 1>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lo, stream)
          : launch_tile<T, kWideCols, 2>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lo, stream);
    }
  }
  if (n <= kThreads) {
    return launch_tile<T, 2, 1>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lo, stream);
  }
  if (n <= 2 * kThreads) {
    return launch_tile<T, 2, 2>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lo, stream);
  }
  constexpr int three = sizeof(T) == 4 ? 8 : 2;
  return launch_tile<T, three, 3>(A, B, X, n, S, bs_r, bs_c, xs_r, xs_c, lo, stream);
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
