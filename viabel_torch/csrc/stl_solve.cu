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
// (0.6 us at 3.35 TB/s), but backward substitution over 32-row panels is 32
// dependent steps, and one column's triangle streamed through one SM takes
// longer than all of them (PERF.md, kernel table and Findings).
//
// Design: blocked backward substitution over panels of 32 rows, from the
// bottom. A tile of W columns of B (W = 1, 2, 4 or 8) is solved by a cluster
// of G blocks (G <= 8): block g owns the panels q = g (mod G), and its warp
// j holds the rows of panel q = g + G j, lane l row 32 q + l, W columns each.
// On the chain, panel P costs:
//  - its owner warp's solve x_P = L_PP^{-T} b_P: 32 independent dot
//    products, one a lane, with the inverse of the diagonal block read from
//    shared memory, where the prologue put it;
//  - the owner's write of x_P into each block of the cluster (distributed
//    shared memory);
//  - one barrier of the cluster, at which every warp but the owner arrives
//    relaxed, so that it does not wait for its own loads in flight;
//  - each warp's rank-32 update of its 32 rows, b -= theta[P, q]^T x_P, with
//    the 32x32 tile of theta it fetched into registers during the step
//    before.
// Off the chain: the diagonal blocks' inverses (one warp a block, each block
// only its own panels; lane c solves L_qq y = e_c by forward substitution in
// registers, in the input type), and every tile's fetch. A column's triangle
// is read by G SMs at once, and no SM inverts more than its share.
//
// Shared memory a block: x_P twice (by the panel's parity) and the owner's
// b_P, 3 * 32 W values, plus its panels' inverses, 576 values each (a packed
// triangle), at most 16 panels: 39 KB in float32 and 78 KB in float64 at
// d = 1536 and W = 8, so the inverses never leave shared memory.
//
// The shape (launch): the narrowest W whose tiles leave room for clusters of
// four, then G the largest power of two, up to 8, that keeps the grid to one
// wave, and never more than 16 panels a block. On an H100 (132 SMs) at
// d = 1000 that is S = 10: W 1, G 8; S = 40: W 2, G 4; S = 160: W 8, G 4;
// S = 400: W 8, G 2: the fastest shape measured at S = 10, 40 and 400, and
// at S = 160 one 11% slower than the best there, the price of one rule for
// every S (PERF.md, Findings). B and X go through their strides, so the
// transposed view of the (S, d) draws that the STL caller passes is read as
// it is.
// Everything runs in the input type: the TPU kernel's bf16-input Newton
// inverses have no counterpart.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>
#include <initializer_list>

namespace {

namespace cg = cooperative_groups;

constexpr int kPanel = 32;        // rows a panel: one a lane
constexpr int kSlot = 576;        // one packed 32x32 triangle, rows and columns padded to 4
constexpr int kMaxWarps = 16;     // panels a block
constexpr int kMaxCluster = 8;    // blocks a column tile: the portable cluster size
constexpr int kMaxDim = 1536;     // the TPU kernel's range (trsm.py:_VMEM_MAX_DIM)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have on sm_90

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// A slot holds one diagonal block twice over. While it is inverted, column
// i of L_qq from row 4 floor(i / 4) down, at col_off(i): the first read of
// each column is 16-byte aligned. Then row j of L_qq^{-1}, columns 0 to
// j rounded up to a multiple of 4, at row_off(j): lane l reads row j's
// entry l, so the chain's reads are one conflict-free line a row.
__host__ __device__ constexpr int col_off(int i) {
  return 128 * (i / 4) - 8 * (i / 4) * (i / 4 - 1) + (i % 4) * (32 - 4 * (i / 4));
}
__host__ __device__ constexpr int row_off(int j) {
  return 8 * (j / 4) * (j / 4 + 1) + (j % 4) * 4 * (j / 4 + 1);
}

// Four consecutive values from a 16-byte-aligned address in shared memory.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

// N values from a 16-byte-aligned row of shared memory, in 16-byte loads
// where N allows.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, T (&x)[N]) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(src)[j];
      x[4 * j] = v.x; x[4 * j + 1] = v.y; x[4 * j + 2] = v.z; x[4 * j + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 8 && N % 2 == 0) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const double2 v = reinterpret_cast<const double2*>(src)[j];
      x[2 * j] = v.x; x[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) x[c] = src[c];
  }
}

// One warp writes L_qq^{-1} for the panel at rows [p0, p0 + 32) into
// `slot`. Lane c solves L_qq y = e_c by forward substitution, y in
// registers; rows past d are the identity's, so the ragged bottom panel
// solves to zeros there.
template <typename T>
__device__ __forceinline__ void invert_panel(const T* __restrict__ theta, int d, int p0,
                                             T* slot, int lane) {
  // stage: lane i takes column i of the block, one coalesced row at a time
  {
    const int i = lane, top = i & ~3;
    T* col = slot + col_off(i) - top;  // col[k] = L[k][i] for k >= top
    const bool live_i = p0 + i < d;
    T v[kPanel];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      v[k] = (p0 + k < d && live_i) ? theta[int64_t(p0 + k) * d + p0 + i] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      if (k >= top) {
        // the diagonal holds 1 / L_ii = exp(-theta_ii), 1 past d
        col[k] = k > i ? v[k] : k == i ? (live_i ? exp_t(-v[k]) : T(1)) : T(0);
      }
    }
  }
  __syncwarp();
  T y[kPanel];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) y[k] = k == lane ? T(1) : T(0);
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    const T* col = slot + col_off(i) - (i & ~3);
    y[i] *= col[i];
#pragma unroll
    for (int g = i / 4; g < kPanel / 4; ++g) {
      T l[4];
      load4(col + 4 * g, l);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * g + e > i) y[4 * g + e] -= l[e] * y[i];
      }
    }
  }
  __syncwarp();  // every lane has read the staged block
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (lane < ((j + 4) & ~3)) slot[row_off(j) + lane] = y[j];  // zero past the diagonal
  }
}

// The cluster's barrier, split in two. The warp that wrote x_P into the
// other blocks arrives with release semantics; the others arrive relaxed: a
// release would first wait for their tile loads still in flight.
__device__ __forceinline__ void cluster_arrive(bool wrote) {
  if (wrote) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int W>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
stl_solve(const T* __restrict__ theta, const T* __restrict__ B, T* __restrict__ X,
          int d, int64_t S, int64_t bs_r, int64_t bs_c, int64_t xs_r, int64_t xs_c) {
  constexpr int A = W < 4 ? 4 / W : 1;                                    // partial sums a column
  constexpr int XR = W * sizeof(T) < 16 ? 16 / (W * int(sizeof(T))) : 1;  // x rows a 16-byte read
  cg::cluster_group cluster = cg::this_cluster();
  const int G = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int lane = threadIdx.x % 32, j = threadIdx.x / 32;
  const int panels = (d + kPanel - 1) / kPanel;
  const int q = rank + G * j;  // the panel whose rows this warp holds (none if q >= panels)
  const int64_t c0 = int64_t(blockIdx.x / G) * W;
  const int cols = int(S - c0 < W ? S - c0 : W);

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [2][32][W]: x_P, by the panel's parity
  T* xin = xs + 2 * kPanel * W;        // [32][W]: the owner's b_P on its way to the solve
  T* inv = xin + kPanel * W;           // [warps][kSlot]: this block's inverted blocks

  // t: the tile theta[32 P + i, 32 q + lane] for the next P this warp applies
  T t[kPanel];
  {
    const int p0 = (panels - 1) * kPanel;
    const bool live = q < panels - 1;
    const T* src = theta + int64_t(p0) * d + q * kPanel + lane;
#pragma unroll
    for (int i = 0; i < kPanel; ++i) t[i] = live && p0 + i < d ? src[int64_t(i) * d] : T(0);
  }
  // b[c]: row 32 q + lane, column c0 + c; zero past d and past S
  T b[W];
  {
    const int k = q * kPanel + lane;
#pragma unroll
    for (int c = 0; c < W; ++c) b[c] = (k < d && c < cols) ? B[k * bs_r + (c0 + c) * bs_c] : T(0);
  }
  if (q < panels) invert_panel(theta, d, q * kPanel, inv + j * kSlot, lane);
  // this block's inverses are in place, and every block of the cluster has
  // started: its shared memory may be written
  cluster.sync();

  for (int P = panels - 1;; --P) {
    T* x = xs + (P % 2) * kPanel * W;
    if (q == P) {
      // x_l = sum_{i >= l} (L_PP^{-1})[i][l] b_i
#pragma unroll
      for (int c = 0; c < W; ++c) xin[lane * W + c] = b[c];
      __syncwarp();
      const T* slot = inv + j * kSlot;
      T acc[A][W];
#pragma unroll
      for (int a = 0; a < A; ++a) {
#pragma unroll
        for (int c = 0; c < W; ++c) acc[a][c] = T(0);
      }
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {
        T bi[W];
        load_row<T, W>(xin + i * W, bi);
        const T u = lane <= i ? slot[row_off(i) + lane] : T(0);
#pragma unroll
        for (int c = 0; c < W; ++c) acc[i % A][c] += u * bi[c];
      }
#pragma unroll
      for (int c = 0; c < W; ++c) {
#pragma unroll
        for (int a = 1; a < A; ++a) acc[0][c] += acc[a][c];
        b[c] = acc[0][c];
      }
      if (P > 0) {
        for (int r = 0; r < G; ++r) {
          T* to = cluster.map_shared_rank(x, unsigned(r)) + lane * W;
#pragma unroll
          for (int c = 0; c < W; ++c) to[c] = b[c];
        }
      }
    }
    if (P == 0) break;
    cluster_arrive(q == P);  // x_P is in every block once all have arrived
    cluster_wait();
    if (q < P) {
      T acc[A][W];
#pragma unroll
      for (int a = 0; a < A; ++a) {
#pragma unroll
        for (int c = 0; c < W; ++c) acc[a][c] = T(0);
      }
#pragma unroll
      for (int i = 0; i < kPanel; i += XR) {
        T xv[XR * W];
        load_row<T, XR * W>(x + i * W, xv);
#pragma unroll
        for (int e = 0; e < XR; ++e) {
#pragma unroll
          for (int c = 0; c < W; ++c) acc[(i + e) % A][c] += t[i + e] * xv[e * W + c];
        }
      }
#pragma unroll
      for (int c = 0; c < W; ++c) {
        T sum = acc[0][c];
#pragma unroll
        for (int a = 1; a < A; ++a) sum += acc[a][c];
        b[c] -= sum;
      }
      // the tile for P - 1, in flight while the chain moves on
      const bool live = q < P - 1;
      const T* src = theta + int64_t(P - 1) * kPanel * d + q * kPanel + lane;
#pragma unroll
      for (int i = 0; i < kPanel; ++i) t[i] = live ? src[int64_t(i) * d] : T(0);
    }
  }

  const int k = q * kPanel + lane;
  if (q < panels && k < d) {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < cols) X[k * xs_r + (c0 + c) * xs_c] = b[c];
    }
  }
}

template <typename T, int W>
int launch_tile(const T* theta, const T* B, T* X, int d, int64_t S, int64_t bs_r,
                int64_t bs_c, int64_t xs_r, int64_t xs_c, int G, cudaStream_t stream) {
  const int panels = (d + kPanel - 1) / kPanel, warps = (panels + G - 1) / G;
  const int64_t blocks = (S + W - 1) / W * G;
  if (blocks > INT32_MAX) return int(cudaErrorInvalidValue);  // grid x
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(unsigned(blocks));
  config.blockDim = dim3(unsigned(32 * warps));
  config.dynamicSmemBytes = size_t(3 * kPanel * W + warps * kSlot) * sizeof(T);
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = unsigned(G);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, stl_solve<T, W>, theta, B, X, d, S, bs_r,
                                           bs_c, xs_r, xs_c);
  return e != cudaSuccess ? int(e) : int(cudaGetLastError());
}

// Dynamic shared memory past 48 KB, for every instantiation. Set once a
// device, at the library's load for the device current then, and at a
// device's first launch otherwise: never inside a graph's capture, which
// follows eager launches on its device.
std::atomic<unsigned long long> g_attributes_set{0};

template <typename T>
cudaError_t allow_smem() {
  cudaError_t e = cudaSuccess;
  for (auto kernel : {stl_solve<T, 1>, stl_solve<T, 2>, stl_solve<T, 4>, stl_solve<T, 8>}) {
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    }
  }
  return e;
}

int set_attributes(int dev) {
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (g_attributes_set.load() & bit)) return 0;
  cudaError_t e = allow_smem<float>();
  if (e == cudaSuccess) e = allow_smem<double>();
  if (e == cudaSuccess && bit) g_attributes_set.fetch_or(bit);
  return int(e);
}

template <typename T>
int launch(const T* theta, const T* B, T* X, int64_t d, int64_t S, int64_t bs_r,
           int64_t bs_c, int64_t xs_r, int64_t xs_c, cudaStream_t stream) {
  if (d <= 0 || d > kMaxDim || S <= 0) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int err = set_attributes(dev);
  if (err != 0) return err;
  const int n = int(d), panels = (n + kPanel - 1) / kPanel;
  int W = 1;
  while (W < 8 && (S + W - 1) / W * 4 > sms) W *= 2;
  const int64_t tiles = (S + W - 1) / W;
  int G = 1;
  while (G < kMaxCluster && 2 * G <= panels && tiles * G * 2 <= sms) G *= 2;
  while (G * kMaxWarps < panels) G *= 2;
  switch (W) {
    case 1: return launch_tile<T, 1>(theta, B, X, n, S, bs_r, bs_c, xs_r, xs_c, G, stream);
    case 2: return launch_tile<T, 2>(theta, B, X, n, S, bs_r, bs_c, xs_r, xs_c, G, stream);
    case 4: return launch_tile<T, 4>(theta, B, X, n, S, bs_r, bs_c, xs_r, xs_c, G, stream);
    default: return launch_tile<T, 8>(theta, B, X, n, S, bs_r, bs_c, xs_r, xs_c, G, stream);
  }
}

}  // namespace

extern "C" int viabel_stl_transpose_solve_init() {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? set_attributes(dev) : int(e);
}

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
