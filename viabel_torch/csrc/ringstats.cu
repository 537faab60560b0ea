// Group statistics of FASO's history ring in one streaming read.
//
// Replaces: viabel_tpu/ops/ringstats.py:_kernel (ring_group_stats, the
// pl.pallas_call at ringstats.py:57).
//
// For every block g of `group` consecutive ring rows:
//     GS[g, j] = sum_{r in block g} (ring[r, j] - center[j])
//     GQ[g, j] = sum_{r in block g} (ring[r, j] - center[j])^2
//
// Bound on the H100: purely bandwidth. It reads R*D elements once and
// writes 2*(R/group)*D; there is no reuse to exploit. At the d=1000
// full-rank flagship the ring is (600, 1_001_000) f32, 2.4 GB, which
// takes about 0.72 ms at the 3.35 TB/s data-sheet rate.
//
// Design: one block per (group, column tile). Each thread owns VEC
// adjacent columns (16 bytes: 4 floats or 2 doubles), loads its slice of
// `center` once, keeps the group's sums in registers, and writes GS/GQ
// once. Neighbouring threads read neighbouring 16-byte words of each ring
// row, so every warp load is fully coalesced. Nothing is carried between
// blocks, which keeps the TPU kernel's "one streaming read, no matmul"
// idea and drops its (8, C) tile packing. A column count or pointer that
// does not allow 16-byte loads takes the scalar path of the same kernel.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

template <typename T>
__device__ __forceinline__ void vload(const T* p, T* out) {
  using V = typename Vec<T>::type;
  V v = *reinterpret_cast<const V*>(p);
  const T* s = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) out[i] = s[i];
}

template <typename T>
__device__ __forceinline__ void vstore(T* p, const T* in) {
  using V = typename Vec<T>::type;
  V v;
  T* s = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) s[i] = in[i];
  *reinterpret_cast<V*>(p) = v;
}

// Vectorised path: D % VEC == 0 and all pointers 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_stats_vec(const T* __restrict__ ring, const T* __restrict__ center,
                T* __restrict__ gs, T* __restrict__ gq, int64_t D, int group) {
  constexpr int VEC = Vec<T>::n;
  const int64_t col = (int64_t(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (col >= D) return;
  const int64_t g = blockIdx.y;
  T c[VEC], s[VEC], q[VEC], x[VEC];
  vload(center + col, c);
#pragma unroll
  for (int i = 0; i < VEC; ++i) { s[i] = T(0); q[i] = T(0); }
  const T* p = ring + g * group * D + col;
#pragma unroll 4
  for (int r = 0; r < group; ++r) {
    vload(p + int64_t(r) * D, x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const T v = x[i] - c[i];
      s[i] += v;
      q[i] += v * v;
    }
  }
  vstore(gs + g * D + col, s);
  vstore(gq + g * D + col, q);
}

// Scalar path for any D and alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_stats_scalar(const T* __restrict__ ring, const T* __restrict__ center,
                   T* __restrict__ gs, T* __restrict__ gq, int64_t D,
                   int group) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= D) return;
  const int64_t g = blockIdx.y;
  const T c = center[col];
  T s = T(0), q = T(0);
  const T* p = ring + g * group * D + col;
#pragma unroll 4
  for (int r = 0; r < group; ++r) {
    const T v = p[int64_t(r) * D] - c;
    s += v;
    q += v * v;
  }
  gs[g * D + col] = s;
  gq[g * D + col] = q;
}

template <typename T>
int launch(const T* ring, const T* center, T* gs, T* gq, int64_t R, int64_t D,
           int64_t group, cudaStream_t stream) {
  if (R <= 0 || D <= 0 || group <= 0 || R % group != 0) return int(cudaErrorInvalidValue);
  const int64_t n_groups = R / group;
  if (n_groups > 65535) return int(cudaErrorInvalidValue);
  constexpr int VEC = Vec<T>::n;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = D % VEC == 0 && aligned(ring) && aligned(center) &&
                   aligned(gs) && aligned(gq);
  const int64_t per_block = vec ? int64_t(kThreads) * VEC : kThreads;
  dim3 grid(unsigned((D + per_block - 1) / per_block), unsigned(n_groups));
  if (vec) {
    group_stats_vec<T><<<grid, kThreads, 0, stream>>>(ring, center, gs, gq, D, int(group));
  } else {
    group_stats_scalar<T><<<grid, kThreads, 0, stream>>>(ring, center, gs, gq, D, int(group));
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int viabel_ring_group_stats_f32(const float* ring, const float* center,
                                           float* gs, float* gq, int64_t R,
                                           int64_t D, int64_t group,
                                           cudaStream_t stream) {
  return launch<float>(ring, center, gs, gq, R, D, group, stream);
}

extern "C" int viabel_ring_group_stats_f64(const double* ring, const double* center,
                                           double* gs, double* gq, int64_t R,
                                           int64_t D, int64_t group,
                                           cudaStream_t stream) {
  return launch<double>(ring, center, gs, gq, R, D, group, stream);
}
