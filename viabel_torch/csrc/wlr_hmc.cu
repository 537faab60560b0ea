// RAABBVI's round regression: a whole multi-chain HMC run in one launch.
//
// Replaces: the XLA program of viabel_tpu/hmc.py:hmc_sample on the
// regression targets of viabel_tpu/faso.py (_wlr_logprob_general and
// _wlr_logprob_averaged): the lax.scan over iterations (hmc.py:110)
// vmapped over chains (hmc.py:145) under jax.jit. There is no Pallas
// kernel on that path; the JAX package runs it on its device as a
// single program, and so does this kernel.
//
// What it computes, in float64, exactly as the plain version
// (viabel_torch/hmc.py:hmc_sample with viabel_torch/ops/wlr.py's
// targets, fed the same random numbers): fixed-trajectory HMC with
// dual-averaging step sizes; two-phase warmup with Welford estimates of a
// diagonal metric over the first warmup half, installed at
// num_warmup / 2 when more than 10 draws were seen (clipped to
// [1e-6, 1e6]) with dual averaging restarted; a NaN log acceptance read as
// -inf. D = 3 is the general target (logit kappa, log c, log sigma),
// D = 2 the averaged-rule one (log c, log sigma). The momentum normals
// (T, C, D) and the acceptance uniforms (T, C) come in from the wrapper,
// drawn from the caller's generator, so kernel and plain version take the
// same numbers. They agree draw for draw over short runs; at 24 leapfrog
// steps the sampler amplifies the last bits of the reassociated sums past
// 1e-9 within tens of iterations, so over a whole run they agree in
// distribution.
//
// Bound on the H100: neither bytes nor operations. A run reads
// T*C*(D+1) random numbers and writes C*num_samples*D draws (about
// 0.15 MB at C = 4, T = 1000), and does about 11 N + 60 FLOP an
// evaluation, microseconds at the card's float64 rate. What sets the
// time is the chain: each chain is T * (num_leapfrog + 1), about 25,000,
// gradient evaluations, each depending on the one before. So the design
// minimises the latency of one evaluation.
//
// Design: one warp a chain, one chain a block (C blocks, each free to
// take its own SM). The lanes run over the N observations, in chunks of
// 32 (CH chunks, a template parameter): y, x and w sit in registers,
// read once. Position, momentum, gradient, metric, dual-averaging state
// and Welford sums are registers too, the same in every lane: every lane
// computes the chain's scalar arithmetic and the butterfly sums leave the
// same bits in every lane, so the lanes never diverge on a decision. An
// evaluation makes its three sums (sum w e^2, sum g_mu, sum g_mu x) in
// one interleaved five-step butterfly, and the log density (four more
// transcendentals) only at the end of a trajectory, where the accept test
// reads it. Lane 0 writes each sampling iteration's position.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void warp_sum3(double& a, double& b, double& c) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const double ta = __shfl_xor_sync(kFull, a, off);
    const double tb = __shfl_xor_sync(kFull, b, off);
    const double tc = __shfl_xor_sync(kFull, c, off);
    a += ta;
    b += tb;
    c += tc;
  }
}

template <int CH>
struct Rows {
  double y[CH], x[CH], w[CH];
  bool in[CH];
};

// The general target (weighted_lin_regression.stan): theta = (logit kappa,
// log c, log sigma); mu = log c + 2 log(rho^-kappa - 1) + 2 kappa x.
// Same operation order as ops/wlr.py:wlr_general.
template <int CH, bool LP>
__device__ __forceinline__ void eval_general(const double* q, const Rows<CH>& r,
                                             double wsum, double log_rho,
                                             double& lp, double* g) {
  const double kappa = 1.0 / (1.0 + exp(-q[0]));
  const double inv_sigma = exp(-q[2]);
  const double r_m1 = expm1(-log_rho * kappa);
  const double a = q[1] + 2.0 * log(r_m1);
  const double b = 2.0 * kappa;
  double wee = 0.0, sum_g = 0.0, sum_gx = 0.0;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (r.in[k]) {
      const double mu = a + b * r.x[k];
      const double e = (r.y[k] - mu) * inv_sigma;
      const double we = r.w[k] * e;
      const double gm = we * inv_sigma;
      wee += we * e;
      sum_g += gm;
      sum_gx += gm * r.x[k];
    }
  }
  warp_sum3(wee, sum_g, sum_gx);
  const double c2 = (0.1 * q[1]) * (0.1 * q[1]);
  const double t = 0.1 / inv_sigma;
  const double s2 = t * t;
  const double dlik = sum_g * (-2.0 * log_rho) * (r_m1 + 1.0) / r_m1 + 2.0 * sum_gx;
  g[0] = dlik * kappa * (1.0 - kappa) + 1.0 - 2.0 * kappa;
  g[1] = sum_g - 0.02 * q[1] / (1.0 + c2);
  g[2] = wee - wsum - 2.0 * s2 / (1.0 + s2) + 1.0;
  if (LP) {
    lp = -0.5 * wee - wsum * q[2] + log(kappa) + log1p(-kappa) - log1p(c2)
         - log1p(s2) + q[2];
  }
}

// The averaged-rule target (weighted_lin_regression_sgd.stan, kappa = 1):
// theta = (log c, log sigma); mu = log c + 2 log(1/rho - 1) + 2 x, the
// constant 2 log(1/rho - 1) passed in as `shift`.
template <int CH, bool LP>
__device__ __forceinline__ void eval_averaged(const double* q, const Rows<CH>& r,
                                              double wsum, double shift,
                                              double& lp, double* g) {
  const double inv_sigma = exp(-q[1]);
  const double a = q[0] + shift;
  double wee = 0.0, sum_g = 0.0, unused = 0.0;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (r.in[k]) {
      const double mu = a + 2.0 * r.x[k];
      const double e = (r.y[k] - mu) * inv_sigma;
      const double we = r.w[k] * e;
      wee += we * e;
      sum_g += we * inv_sigma;
    }
  }
  warp_sum3(wee, sum_g, unused);
  const double c2 = (0.1 * q[0]) * (0.1 * q[0]);
  const double t = 0.1 / inv_sigma;
  const double s2 = t * t;
  g[0] = sum_g - 0.02 * q[0] / (1.0 + c2);
  g[1] = wee - wsum - 2.0 * s2 / (1.0 + s2) + 1.0;
  if (LP) lp = -0.5 * wee - wsum * q[1] - log1p(c2) - log1p(s2) + q[1];
}

template <int D, int CH, bool LP>
__device__ __forceinline__ void eval(const double* q, const Rows<CH>& r, double wsum,
                                     double log_rho, double shift, double& lp,
                                     double* g) {
  if constexpr (D == 3) {
    eval_general<CH, LP>(q, r, wsum, log_rho, lp, g);
  } else {
    eval_averaged<CH, LP>(q, r, wsum, shift, lp, g);
  }
}

// Dual averaging (Hoffman & Gelman 2014, section 3.2), as hmc.py's
// _da_init / _da_update: gamma 0.05, t0 10, kappa 0.75.
struct DualAverage {
  double log_eps, log_eps_bar, h_bar, mu, i;

  __device__ void init(double step) {
    log_eps = log(step);
    log_eps_bar = log(step);
    h_bar = 0.0;
    mu = log(10.0 * step);
    i = 0.0;
  }

  __device__ void update(double accept_prob, double target_accept) {
    const double t = i + 1.0;
    const double eta_h = 1.0 / (t + 10.0);
    h_bar = (1.0 - eta_h) * h_bar + eta_h * (target_accept - accept_prob);
    log_eps = mu - sqrt(t) / 0.05 * h_bar;
    const double eta = pow(t, -0.75);
    log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar;
    i = t;
  }
};

template <int D, int CH>
__global__ void __launch_bounds__(kWarp)
wlr_hmc_kernel(const double* __restrict__ init, const double* __restrict__ normals,
               const double* __restrict__ uniforms, const double* __restrict__ y,
               const double* __restrict__ x, const double* __restrict__ w,
               double* __restrict__ draws, int C, int N, int num_warmup,
               int num_samples, int num_leapfrog, double log_rho, double shift,
               double target_accept, double init_step_size) {
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  Rows<CH> r;
  double wsum = 0.0, unused_a = 0.0, unused_b = 0.0;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int n = lane + k * kWarp;
    r.in[k] = n < N;
    r.y[k] = r.in[k] ? y[n] : 0.0;
    r.x[k] = r.in[k] ? x[n] : 0.0;
    r.w[k] = r.in[k] ? w[n] : 0.0;
    wsum += r.w[k];
  }
  warp_sum3(wsum, unused_a, unused_b);

  double q[D], g[D], lp;
  double inv_mass[D], wf_mean[D], wf_m2[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    q[j] = init[c * D + j];
    inv_mass[j] = 1.0;
    wf_mean[j] = 0.0;
    wf_m2[j] = 0.0;
  }
  double wf_n = 0.0;
  eval<D, CH, true>(q, r, wsum, log_rho, shift, lp, g);
  DualAverage da;
  da.init(init_step_size);
  const int total = num_warmup + num_samples;
  const int phase_switch = num_warmup / 2;

  for (int it = 0; it < total; ++it) {
    const bool warming = it < num_warmup;
    const double eps = exp(warming ? da.log_eps : da.log_eps_bar);
    const double* z = normals + (int64_t(it) * C + c) * D;
    double p[D], qn[D], gn[D], eim[D], lpn = 0.0;
    double kin0 = 0.0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      // momenta ~ N(0, M), M = diag(1 / inv_mass)
      p[j] = z[j] / sqrt(inv_mass[j]);
      kin0 += inv_mass[j] * (p[j] * p[j]);
      qn[j] = q[j];
      gn[j] = g[j];
      eim[j] = eps * inv_mass[j];
    }
    const double h0 = lp - 0.5 * kin0;
    const double half_eps = 0.5 * eps;
    for (int l = 0; l < num_leapfrog; ++l) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        p[j] = p[j] + half_eps * gn[j];
        qn[j] = qn[j] + eim[j] * p[j];
      }
      if (l + 1 < num_leapfrog) {
        eval<D, CH, false>(qn, r, wsum, log_rho, shift, lpn, gn);
      } else {
        eval<D, CH, true>(qn, r, wsum, log_rho, shift, lpn, gn);
      }
#pragma unroll
      for (int j = 0; j < D; ++j) p[j] = p[j] + half_eps * gn[j];
    }
    double kin1 = 0.0;
#pragma unroll
    for (int j = 0; j < D; ++j) kin1 += inv_mass[j] * (p[j] * p[j]);
    const double h1 = lpn - 0.5 * kin1;
    double log_accept = h1 - h0;
    log_accept = isnan(log_accept) ? -INFINITY : fmin(log_accept, 0.0);
    if (log(uniforms[int64_t(it) * C + c]) < log_accept) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        q[j] = qn[j];
        g[j] = gn[j];
      }
      lp = lpn;
    }
    if (warming) da.update(exp(log_accept), target_accept);
    if (it < phase_switch) {  // Welford over the first warmup half
      wf_n += 1.0;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const double delta = q[j] - wf_mean[j];
        wf_mean[j] = wf_mean[j] + delta / wf_n;
        wf_m2[j] = wf_m2[j] + delta * (q[j] - wf_mean[j]);
      }
    }
    if (it == phase_switch) {
      // install the estimated metric (a NaN passes the clip, as in
      // torch.clamp) and restart dual averaging from the averaged step
      if (wf_n > 10.0) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const double v = wf_m2[j] / fmax(wf_n - 1.0, 1.0);
          inv_mass[j] = v < 1e-6 ? 1e-6 : (v > 1e6 ? 1e6 : v);
        }
      }
      da.init(exp(da.log_eps_bar));
    }
    if (!warming && lane == 0) {
      double* out = draws + (int64_t(c) * num_samples + (it - num_warmup)) * D;
#pragma unroll
      for (int j = 0; j < D; ++j) out[j] = q[j];
    }
  }
}

template <int D>
cudaError_t launch(const double* init, const double* normals, const double* uniforms,
                   const double* y, const double* x, const double* w, double* draws,
                   int C, int N, int num_warmup, int num_samples, int num_leapfrog,
                   double log_rho, double shift, double target_accept,
                   double init_step_size, cudaStream_t stream) {
  const dim3 grid(C), block(kWarp);
#define VIABEL_WLR_LAUNCH(CH)                                                      \
  wlr_hmc_kernel<D, CH><<<grid, block, 0, stream>>>(                               \
      init, normals, uniforms, y, x, w, draws, C, N, num_warmup, num_samples,      \
      num_leapfrog, log_rho, shift, target_accept, init_step_size)
  if (N <= 1 * kWarp) VIABEL_WLR_LAUNCH(1);
  else if (N <= 2 * kWarp) VIABEL_WLR_LAUNCH(2);
  else if (N <= 4 * kWarp) VIABEL_WLR_LAUNCH(4);
  else if (N <= 8 * kWarp) VIABEL_WLR_LAUNCH(8);
  else if (N <= 16 * kWarp) VIABEL_WLR_LAUNCH(16);
  else if (N <= 32 * kWarp) VIABEL_WLR_LAUNCH(32);
  else return cudaErrorInvalidValue;
#undef VIABEL_WLR_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// init (C, D), normals (T, C, D), uniforms (T, C), y / x / w (N,), draws
// (C, num_samples, D); all contiguous float64 on one device, T =
// num_warmup + num_samples, D in {2, 3}, 1 <= N <= 1024,
// num_leapfrog >= 1. log_rho = log(rho) (D = 3), shift = 2 log(1/rho - 1)
// (D = 2).
extern "C" cudaError_t viabel_wlr_hmc_f64(
    const double* init, const double* normals, const double* uniforms,
    const double* y, const double* x, const double* w, double* draws, int64_t C,
    int64_t D, int64_t N, int64_t num_warmup, int64_t num_samples,
    int64_t num_leapfrog, double log_rho, double shift, double target_accept,
    double init_step_size, cudaStream_t stream) {
  if (C < 1 || N < 1 || num_warmup < 0 || num_samples < 1 || num_leapfrog < 1)
    return cudaErrorInvalidValue;
  const int c = int(C), n = int(N), nw = int(num_warmup), ns = int(num_samples),
            nl = int(num_leapfrog);
  if (D == 3)
    return launch<3>(init, normals, uniforms, y, x, w, draws, c, n, nw, ns, nl,
                     log_rho, shift, target_accept, init_step_size, stream);
  if (D == 2)
    return launch<2>(init, normals, uniforms, y, x, w, draws, c, n, nw, ns, nl,
                     log_rho, shift, target_accept, init_step_size, stream);
  return cudaErrorInvalidValue;
}
