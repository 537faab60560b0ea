// The mean-field Gaussian's sticking-the-landing draw and score, one pass
// over the (S, d) draws each way.
//
// Replaces no Pallas kernel: the JAX package's MFGaussian STL step is plain
// XLA (families.py's sample and log_density under stop_gradient), which a
// TPU fuses by itself. PyTorch runs it as some twenty elementwise and
// reduction passes over S x d, so this kernel pair was added for the port.
//
// Forward, from base normals z (S, d) and var_param = [mu, log_sigma]:
//     x[s, j]  = mu[j] + sigma[j] z[s, j],   sigma = exp(log_sigma)
//     log q[s] = -0.5 sum_j z[s, j]^2 - sum_j log_sigma[j] - d/2 log 2 pi
// The value uses the identity (x - mu) / sigma = z, as FullRankGaussian's
// STL route does. Backward, from g_x (S, d, or none) and g_lq (S, or none),
// with log q's parameters held fixed (the STL estimator), the only path to
// var_param is x, and d log q / dx = -z / sigma:
//     G[s, j]         = g_x[s, j] - g_lq[s] z[s, j] / sigma[j]
//     d mu[j]         = sum_s G[s, j]
//     d log_sigma[j]  = sigma[j] sum_s G[s, j] z[s, j]
//
// Bound on the H100: bytes. The least traffic is z read and x written going
// forward, g_x and z read going back: 4 S d elements, plus 5 d for the
// parameters and their gradient and 2 S for log q and g_lq, at about one
// operation a byte. At S = 400 and d = 478,410 in float32 that is 3.07 GB,
// 0.917 ms at 3.35 TB/s.
//
// Design: one streaming pass each way. A block owns a tile of 256 x CPT
// columns (CPT = 16 bytes of columns a thread: 4 floats or 2 doubles), read
// as vectors of VEC elements, VEC the widest that d and every pointer's
// alignment allow (the rows of an (S, d) tensor are 16-byte aligned only when
// d is a multiple of 16 bytes: at d = 478,410 floats they are 8-byte aligned,
// so 2-float vectors), neighbouring threads on neighbouring vectors
// so every warp load is coalesced. mu and sigma stay in registers.
//  - mf_stl_draw: a 2-D grid of column tiles and groups of kRows rows. Each
//    row's sum of squares over the tile is reduced in the block in double and
//    written to a (S, n_tiles) scratch, and the row group 0 blocks write the
//    tile's sum of log_sigma. mf_stl_rows, one block a row, adds the tiles
//    in a fixed order. No atomics: the result does not depend on the order
//    blocks run in, so a replayed CUDA graph gives an eager step's bits.
//  - mf_stl_grad: each thread walks the S rows of its columns, keeping sum_s
//    G and sum_s G z in double. Where the column tiles alone leave the card
//    short of kMinBlocks blocks (small d), S is split across blocks; the
//    splits' partial sums go to a scratch and mf_stl_grad_sum adds them in
//    a fixed order.
// The launch shape depends on S, d and the pointers' alignment alone. x is
// mu + sigma z rounded as the plain version rounds it (no fused
// multiply-add), so the draws equal the plain version's.

#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows a draw block walks: loads in flight for a thread, and the mu/sigma
// registers reused kRows times
constexpr int kRows = 8;
// two blocks an SM of the H100's 132: below that, the gradient splits S
constexpr int64_t kMinBlocks = 264;
// the fewest rows a split of the gradient walks
constexpr int64_t kMinSplitRows = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__host__ __device__ constexpr int cols_per_thread() { return int(16 / sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int64_t tile_cols() {
  return int64_t(kThreads) * cols_per_thread<T>();
}

// the widest vector of T a thread loads (4 floats or 2 doubles)
template <typename T>
constexpr int kWidest = cols_per_thread<T>();

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float exp_of(float a) { return expf(a); }
__device__ __forceinline__ double exp_of(double a) { return exp(a); }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Column of element i of vector k of this thread in tile `tile`.
template <typename T, int VEC>
__device__ __forceinline__ int64_t column(int64_t tile, int k) {
  return tile * tile_cols<T>() + int64_t(k) * kThreads * VEC + int64_t(threadIdx.x) * VEC;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mf_stl_draw(const T* __restrict__ z, const T* __restrict__ mu, const T* __restrict__ log_sigma,
            T* __restrict__ x, double* __restrict__ row_part, double* __restrict__ ls_part,
            int64_t S, int64_t d, int64_t n_tiles) {
  constexpr int NV = cols_per_thread<T>() / VEC;
  using P = Pack<T, VEC>;
  __shared__ double red[kWarps][kRows + 1];
  const int64_t tile = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  P m[NV], sg[NV];
  bool live[NV];
  double ls_sum = 0.0;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int64_t c = column<T, VEC>(tile, k);
    live[k] = c < d;  // d % VEC == 0, so a live vector lies wholly inside
    if (live[k]) {
      m[k] = *reinterpret_cast<const P*>(mu + c);
      const P ls = *reinterpret_cast<const P*>(log_sigma + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sg[k].v[i] = exp_of(ls.v[i]);
        ls_sum += double(ls.v[i]);
      }
    }
  }
  const int64_t n_groups = (S + kRows - 1) / kRows;
  for (int64_t g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int64_t r0 = g * kRows;
    double acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r] = 0.0;
      if (r0 + r < S) {
        const int64_t off = (r0 + r) * d;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (!live[k]) continue;
          const int64_t c = column<T, VEC>(tile, k);
          const P zv = *reinterpret_cast<const P*>(z + off + c);
          P xv;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            xv.v[i] = add_rn(m[k].v[i], mul_rn(sg[k].v[i], zv.v[i]));
            const double zd = double(zv.v[i]);
            acc[r] += zd * zd;
          }
          *reinterpret_cast<P*>(x + off + c) = xv;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
    const bool first = g == 0;
    if (first) ls_sum = warp_sum(ls_sum);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) red[warp][r] = acc[r];
      red[warp][kRows] = ls_sum;
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < kRows && r0 + r < S) {
      double t = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][r];
      row_part[(r0 + r) * n_tiles + tile] = t;
    } else if (r == kRows && first) {
      double t = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][kRows];
      ls_part[tile] = t;
    }
    __syncthreads();
  }
}

// One block a row: log q[s] from the row's tile sums and the tiles' sums of
// log_sigma, each added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mf_stl_rows(const double* __restrict__ row_part, const double* __restrict__ ls_part,
            T* __restrict__ log_q, int64_t n_tiles, double log_norm) {
  __shared__ double red[2][kWarps];
  const int64_t s = blockIdx.x;
  double a = 0.0, b = 0.0;
  for (int64_t t = threadIdx.x; t < n_tiles; t += kThreads) {
    a += row_part[s * n_tiles + t];
    b += ls_part[t];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sa = 0.0, sb = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += red[0][w];
      sb += red[1][w];
    }
    log_q[s] = T(-0.5 * sa - sb - log_norm);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mf_stl_grad(const T* __restrict__ g_x, const T* __restrict__ g_lq, const T* __restrict__ z,
            const T* __restrict__ log_sigma, T* __restrict__ grad, double* __restrict__ part,
            int64_t S, int64_t d, int64_t rows_per_split) {
  constexpr int NV = cols_per_thread<T>() / VEC;
  using P = Pack<T, VEC>;
  const int64_t tile = blockIdx.x;
  const int64_t r_begin = int64_t(blockIdx.y) * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < S ? r_begin + rows_per_split : S;
  double sigma[NV][VEC], inv[NV][VEC], a[NV][VEC], b[NV][VEC];
  bool live[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int64_t c = column<T, VEC>(tile, k);
    live[k] = c < d;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sigma[k][i] = live[k] ? exp(double(log_sigma[c + i])) : 1.0;
      inv[k][i] = 1.0 / sigma[k][i];
      a[k][i] = 0.0;
      b[k][i] = 0.0;
    }
  }
#pragma unroll 4
  for (int64_t s = r_begin; s < r_end; ++s) {
    const double w = g_lq != nullptr ? double(g_lq[s]) : 0.0;
    const int64_t off = s * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!live[k]) continue;
      const int64_t c = column<T, VEC>(tile, k);
      const P zv = *reinterpret_cast<const P*>(z + off + c);
      P gv;
      if (g_x != nullptr) {
        gv = *reinterpret_cast<const P*>(g_x + off + c);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) gv.v[i] = T(0);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const double zd = double(zv.v[i]);
        const double G = double(gv.v[i]) - w * zd * inv[k][i];
        a[k][i] += G;
        b[k][i] += G * zd;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!live[k]) continue;
    const int64_t c = column<T, VEC>(tile, k);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (gridDim.y == 1) {
        grad[c + i] = T(a[k][i]);
        grad[d + c + i] = T(sigma[k][i] * b[k][i]);
      } else {
        double* p = part + int64_t(blockIdx.y) * 2 * d;
        p[c + i] = a[k][i];
        p[d + c + i] = b[k][i];
      }
    }
  }
}

// One thread a column: the splits' partial sums added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mf_stl_grad_sum(const double* __restrict__ part, const T* __restrict__ log_sigma,
                T* __restrict__ grad, int64_t d, int64_t splits) {
  const int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= d) return;
  double a = 0.0, b = 0.0;
  for (int64_t k = 0; k < splits; ++k) {
    a += part[k * 2 * d + c];
    b += part[k * 2 * d + d + c];
  }
  grad[c] = T(a);
  grad[d + c] = T(exp(double(log_sigma[c])) * b);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// The widest vector (in elements) that d and every pointer allow.
template <typename T>
int vector_width(int64_t d, std::initializer_list<const void*> ptrs) {
  for (int vec = cols_per_thread<T>(); vec > 1; vec /= 2) {
    bool ok = d % vec == 0;
    for (const void* p : ptrs) ok = ok && aligned(p, vec * int(sizeof(T)));
    if (ok) return vec;
  }
  return 1;
}

int64_t n_tiles_of(int64_t d, int64_t elsize) {
  const int64_t cols = int64_t(kThreads) * (16 / elsize);
  return (d + cols - 1) / cols;
}

// Splits of S for the gradient: enough blocks for the card where d is small,
// never fewer than kMinSplitRows rows a split.
int64_t grad_splits(int64_t S, int64_t d, int64_t elsize) {
  const int64_t tiles = n_tiles_of(d, elsize);
  int64_t want = (kMinBlocks + tiles - 1) / tiles;
  const int64_t most = (S + kMinSplitRows - 1) / kMinSplitRows;
  if (want > most) want = most;
  if (want > 65535) want = 65535;
  if (want < 1) want = 1;
  const int64_t rows = (S + want - 1) / want;
  return (S + rows - 1) / rows;  // no empty split
}

template <typename T>
int launch_forward(const T* z, const T* mu, const T* log_sigma, T* x, T* log_q,
                   double* scratch, int64_t S, int64_t d, cudaStream_t stream) {
  if (S < 0 || d <= 0) return int(cudaErrorInvalidValue);
  if (S == 0) return int(cudaSuccess);
  const int64_t tiles = n_tiles_of(d, sizeof(T));
  const int64_t groups = (S + kRows - 1) / kRows;
  if (tiles > 0x7fffffff || S > 0x7fffffff) return int(cudaErrorInvalidValue);
  double* row_part = scratch;
  double* ls_part = scratch + S * tiles;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(groups < 65535 ? groups : 65535));
  switch (vector_width<T>(d, {z, mu, log_sigma, x})) {
    case 4:  // float only: a double's 16 bytes are two
      mf_stl_draw<T, kWidest<T>><<<grid, kThreads, 0, stream>>>(
          z, mu, log_sigma, x, row_part, ls_part, S, d, tiles);
      break;
    case 2:
      mf_stl_draw<T, 2><<<grid, kThreads, 0, stream>>>(
          z, mu, log_sigma, x, row_part, ls_part, S, d, tiles);
      break;
    default:
      mf_stl_draw<T, 1><<<grid, kThreads, 0, stream>>>(
          z, mu, log_sigma, x, row_part, ls_part, S, d, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const double log_norm = 0.5 * double(d) * 1.8378770664093454835606594728112;  // log 2 pi
  mf_stl_rows<T><<<unsigned(S), kThreads, 0, stream>>>(row_part, ls_part, log_q, tiles, log_norm);
  return int(cudaGetLastError());
}

template <typename T>
int launch_backward(const T* g_x, const T* g_lq, const T* z, const T* log_sigma, T* grad,
                    double* scratch, int64_t S, int64_t d, cudaStream_t stream) {
  if (S < 0 || d <= 0) return int(cudaErrorInvalidValue);
  const int64_t tiles = n_tiles_of(d, sizeof(T));
  if (tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  const int64_t splits = S == 0 ? 1 : grad_splits(S, d, sizeof(T));
  const int64_t rows = S == 0 ? 0 : (S + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits));
  switch (vector_width<T>(d, {g_x, z, log_sigma, grad})) {
    case 4:  // float only
      mf_stl_grad<T, kWidest<T>><<<grid, kThreads, 0, stream>>>(
          g_x, g_lq, z, log_sigma, grad, scratch, S, d, rows);
      break;
    case 2:
      mf_stl_grad<T, 2><<<grid, kThreads, 0, stream>>>(
          g_x, g_lq, z, log_sigma, grad, scratch, S, d, rows);
      break;
    default:
      mf_stl_grad<T, 1><<<grid, kThreads, 0, stream>>>(
          g_x, g_lq, z, log_sigma, grad, scratch, S, d, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  const unsigned blocks = unsigned((d + kThreads - 1) / kThreads);
  mf_stl_grad_sum<T><<<blocks, kThreads, 0, stream>>>(scratch, log_sigma, grad, d, splits);
  return int(cudaGetLastError());
}

}  // namespace

// Doubles of scratch a call needs: the forward's (S, n_tiles) row sums and
// n_tiles log_sigma sums; the backward's (splits, 2 d) partial sums, none
// when it does not split S.
extern "C" int viabel_mf_stl_scratch(int64_t S, int64_t d, int64_t elsize, int backward,
                                     int64_t* out) {
  if (S < 0 || d <= 0 || (elsize != 4 && elsize != 8)) return int(cudaErrorInvalidValue);
  const int64_t tiles = n_tiles_of(d, elsize);
  if (!backward) {
    *out = S * tiles + tiles;
  } else {
    const int64_t splits = S == 0 ? 1 : grad_splits(S, d, elsize);
    *out = splits > 1 ? splits * 2 * d : 0;
  }
  return int(cudaSuccess);
}

extern "C" int viabel_mf_stl_forward_f32(const float* z, const float* mu,
                                         const float* log_sigma, float* x, float* log_q,
                                         double* scratch, int64_t S, int64_t d,
                                         cudaStream_t stream) {
  return launch_forward<float>(z, mu, log_sigma, x, log_q, scratch, S, d, stream);
}

extern "C" int viabel_mf_stl_forward_f64(const double* z, const double* mu,
                                         const double* log_sigma, double* x, double* log_q,
                                         double* scratch, int64_t S, int64_t d,
                                         cudaStream_t stream) {
  return launch_forward<double>(z, mu, log_sigma, x, log_q, scratch, S, d, stream);
}

extern "C" int viabel_mf_stl_backward_f32(const float* g_x, const float* g_lq, const float* z,
                                          const float* log_sigma, float* grad, double* scratch,
                                          int64_t S, int64_t d, cudaStream_t stream) {
  return launch_backward<float>(g_x, g_lq, z, log_sigma, grad, scratch, S, d, stream);
}

extern "C" int viabel_mf_stl_backward_f64(const double* g_x, const double* g_lq,
                                          const double* z, const double* log_sigma,
                                          double* grad, double* scratch, int64_t S, int64_t d,
                                          cudaStream_t stream) {
  return launch_backward<double>(g_x, g_lq, z, log_sigma, grad, scratch, S, d, stream);
}
