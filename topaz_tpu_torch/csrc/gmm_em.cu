// EM of the GMM normalization for Hopper (sm_90a): every (image, lane) fit
// of a call runs to its end in one launch.
//
// Replaces the EM loop of the JAX package's gmm_fit
// (topaz_tpu/ops/gmm.py:72-171), one jax.lax.while_loop (:169) that
// norm_fit and norm_fit_hist vmap over the 11 pi lanes and, in the batched
// pipeline, over a shape bucket's images. On the TPU that loop is one
// device program whose lanes stop on their own. It is not a Pallas kernel:
// XLA lowered it. The port's plain version, ops/gmm._gmm_fit_plain, runs the
// same steps as eager PyTorch with one host check a step.
//
// What it computes. For image b (N pixels x, weights w: 0/1 validity, the
// counts of a histogram, or none) and lane l (initial pi and a split
// value), with n the sum of w:
//
//   init   p0 = (x <= split) w, p1 = w - p0; mu0, mu1 the p-weighted means
//          (mu = sum x w / n where a component is empty); one shared
//          variance var = sum (p0 (x - mu0)^2 + p1 (x - mu1)^2) / n;
//          Z = logsumexp(log N(x; mu0, var) + log(1 - pi),
//                        log N(x; mu1, var) + log pi);
//          logp = scale sum w Z + log Beta(pi; alpha, beta)
//   step   p0, p1 = exp(log_p0 - Z) w, exp(log_p1 - Z) w at the current
//          parameters; pi = (a - 1) / (a + b - 2), a = alpha + sum p1,
//          b = beta + n - sum p1 (the MAP update); mu0, mu1 and var as in
//          the init; Z and logp at the new parameters. The lane stops after
//          a step whose logp - logp_cur <= tol, or after num_iters steps;
//          logp_cur is the last logp that was not such a step, as the JAX
//          loop's state keeps it.
//
// and writes (logp, mu0, var, mu1, var, pi) and the steps it took.
//
// Agreement with the plain version. Each pixel's terms are rounded op by op
// as the plain version's float32 tensor ops round them (the __f*_rn
// intrinsics keep nvcc from contracting them into fma; expf, logf and
// log1pf are the functions PyTorch's CUDA kernels call), and every sum is
// taken in float64 and rounded to float32 once, as the plain version's
// twin (_gmm_fit_plain with acc=float64) takes its sums. So the two differ
// only where two float64 sums of the same float32 terms, taken in other
// orders, round to different float32 values, and a lane stops at the same
// step as in the twin. (The CPU path's float32 sums, like JAX's, round
// each partial sum: a lane whose logp - logp_cur lies within a few float32
// ulps of tol may stop a step apart from the kernel there.)
//
// Design. One block owns one (image, lane) pair and runs that lane's whole
// loop: 88 blocks for a bucket of 8 images, 11 for one image. A block has
// 1024 threads and its pixel loops are unrolled 4 times (54-60 registers a
// thread, no spills): the chains of dependent divisions, exp and log wait
// on latency more than on issue, and on an H100 a fit of 8 x 512^2 took
// 29.9 ms so, 33.2 ms without the unroll and 46.5 ms with 512 threads
// (tools/profile_torch_gmm_em.py, PERF.md). Blocks need no grid-wide
// barrier, and a lane that stops frees its SM while the others go on.
// Each pass over the image reads x (and w) from L2 (a bucket of 8 x 512^2
// is 16 MB of x and w); each thread keeps float64 partial sums of a fixed
// stride of pixels, and the block reduces them by warp shuffles and then
// across warps in a fixed order, so a fit is the same from run to run. Every thread computes the lane's scalar update itself from the
// reduced sums in shared memory, so the update needs no further barrier.
// A step takes two passes: the variance at the new means needs the
// responsibilities at the old parameters (recomputed, not stored: 88 lanes
// of 512^2 float32 would be 92 MB, beyond L2), and one pass at the new
// parameters gives both sum w Z and the next step's sums of p0, p1, x p0
// and x p1.
//
// Bound. Each step evaluates the posteriors once a pixel and lane: five
// transcendental functions (two exp and a log for Z, two exp for p0 and
// p1), each one MUFU operation at the core of its library routine, and
// ~30 float32 operations; x and w are read once, 8 bytes a pixel. With the
// 16 MUFU results a clock an SM of compute capability 9.0, a fit of the
// 512 x 512 x 8 bucket is MUFU-bound by far: ~28 us a step for all 88
// lanes, against 5 us to read the 16 MB once. The kernel does each
// posterior evaluation twice a step, and a lane runs only on its own SM;
// PERF.md has its measured times beside the bound.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// 2 * math.pi as the plain version's float32 multiply rounds it
constexpr float kTwoPi = 6.28318530717958647692f;

// one lane's parameters, with the constants of its two log densities
struct Params {
  float mu0, mu1, var, pi;
  float c;   // 0.5 log(2 pi var)
  float l0;  // log(1 - pi), as log1p(-pi)
  float l1;  // log(pi)
};

__device__ __forceinline__ Params make_params(float mu0, float mu1, float var, float pi) {
  Params p;
  p.mu0 = mu0;
  p.mu1 = mu1;
  p.var = var;
  p.pi = pi;
  p.c = __fmul_rn(0.5f, logf(__fmul_rn(kTwoPi, var)));
  p.l0 = log1pf(-pi);
  p.l1 = logf(pi);
  return p;
}

// torch.maximum: NaN when either side is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// -(x - mu)^2 / 2 / var - 0.5 log(2 pi var) + log prior, in that order
__device__ __forceinline__ float log_density(float x, float mu, const Params& p, float lw) {
  const float d = __fsub_rn(x, mu);
  const float q = __fmul_rn(-__fmul_rn(d, d), 0.5f);
  return __fadd_rn(__fsub_rn(__fdiv_rn(q, p.var), p.c), lw);
}

// Z of one pixel and its two unweighted responsibilities
__device__ __forceinline__ float posteriors(float x, const Params& p, float& r0, float& r1) {
  const float lp0 = log_density(x, p.mu0, p, p.l0);
  const float lp1 = log_density(x, p.mu1, p, p.l1);
  const float ma = nan_max(lp0, lp1);
  const float z = __fadd_rn(
      ma, logf(__fadd_rn(expf(__fsub_rn(lp0, ma)), expf(__fsub_rn(lp1, ma)))));
  r0 = expf(__fsub_rn(lp0, z));
  r1 = expf(__fsub_rn(lp1, z));
  return z;
}

// the weighted responsibilities of a pixel: the hard split of the init, or
// the posteriors at `p`
template <bool kHard>
__device__ __forceinline__ void responsibilities(float x, float w, const Params& p, float split,
                                                 float& p0, float& p1) {
  if (kHard) {
    p0 = __fmul_rn(x <= split ? 1.0f : 0.0f, w);
    p1 = __fsub_rn(w, p0);
  } else {
    float r0, r1;
    posteriors(x, p, r0, r1);
    p0 = __fmul_rn(r0, w);
    p1 = __fmul_rn(r1, w);
  }
}

// Sums every thread's K partial sums over the block, in a fixed order, into
// total[K]; on return every thread may read total.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K], double* scratch, double* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(kFull, v[k], off);
    if (lane == 0) scratch[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double t = lane < kWarps ? scratch[k * kWarps + lane] : 0.0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
      if (lane == 0) total[k] = t;
    }
  }
  __syncthreads();
}

// sum x w (kHard only, else sum w Z at `p`), sum p0, sum p1, sum x p0 and
// sum x p1 of this thread's pixels
template <bool kWeighted, bool kHard>
__device__ __forceinline__ void sums_pass(const float* __restrict__ x, const float* __restrict__ w,
                                          int N, const Params& p, float split, double (&acc)[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) acc[k] = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const float xi = x[i];
    const float wi = kWeighted ? w[i] : 1.0f;
    float p0, p1;
    if (kHard) {
      responsibilities<true>(xi, wi, p, split, p0, p1);
      acc[0] += static_cast<double>(__fmul_rn(xi, wi));
    } else {
      float r0, r1;
      const float z = posteriors(xi, p, r0, r1);
      p0 = __fmul_rn(r0, wi);
      p1 = __fmul_rn(r1, wi);
      acc[0] += static_cast<double>(__fmul_rn(wi, z));
    }
    acc[1] += static_cast<double>(p0);
    acc[2] += static_cast<double>(p1);
    acc[3] += static_cast<double>(__fmul_rn(xi, p0));
    acc[4] += static_cast<double>(__fmul_rn(xi, p1));
  }
}

// sum p0 (x - mu0)^2 + p1 (x - mu1)^2 of this thread's pixels, with the
// responsibilities of the init's split or of the parameters `p`
template <bool kWeighted, bool kHard>
__device__ __forceinline__ void variance_pass(const float* __restrict__ x,
                                              const float* __restrict__ w, int N,
                                              const Params& p, float split, float mu0, float mu1,
                                              double (&acc)[1]) {
  acc[0] = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const float xi = x[i];
    const float wi = kWeighted ? w[i] : 1.0f;
    float p0, p1;
    responsibilities<kHard>(xi, wi, p, split, p0, p1);
    const float d0 = __fsub_rn(xi, mu0);
    const float d1 = __fsub_rn(xi, mu1);
    acc[0] += static_cast<double>(
        __fadd_rn(__fmul_rn(p0, __fmul_rn(d0, d0)), __fmul_rn(p1, __fmul_rn(d1, d1))));
  }
}

// sum x p / sum p, or mu where the component holds no weight
__device__ __forceinline__ float weighted_mean(double sp, double sxp, float mu) {
  const float s = static_cast<float>(sp);
  return s > 0.0f ? __fdiv_rn(static_cast<float>(sxp), s) : mu;
}

// log Beta(pi; alpha, beta), finite at pi = 1 when beta == 1 and at pi = 0
// when alpha == 1; betaln = log B(alpha, beta) from the host
__device__ __forceinline__ float beta_logpdf(float pi, float alpha, float beta, float betaln) {
  const float ta = alpha == 1.0f ? 0.0f : __fmul_rn(__fsub_rn(alpha, 1.0f), logf(pi));
  const float tb = beta == 1.0f ? 0.0f : __fmul_rn(__fsub_rn(beta, 1.0f), log1pf(-pi));
  return __fsub_rn(__fadd_rn(ta, tb), betaln);
}

// One block a (image, lane) pair: blockIdx.x = b * L + l.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
gmm_em(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ n,
       const float* __restrict__ pi0, const float* __restrict__ split, int N, int L,
       int lanes, float alpha, float beta, float scale, float tol, int num_iters,
       float betaln, float* __restrict__ out, int* __restrict__ steps) {
  __shared__ double scratch[5 * kWarps];
  __shared__ double total[5];

  const int lane = blockIdx.x;
  const int b = lane / L;
  const float* xb = x + static_cast<size_t>(b) * N;
  const float* wb = kWeighted ? w + static_cast<size_t>(b) * N : nullptr;
  const float nb = n[b];
  const float cut = split[lane];
  double acc[5];
  double acc1[1];

  // init: the hard split at `cut`
  Params p = make_params(0.0f, 0.0f, 1.0f, 0.5f);  // unread by the hard passes
  sums_pass<kWeighted, true>(xb, wb, N, p, cut, acc);
  block_sum(acc, scratch, total);
  const float mu = __fdiv_rn(static_cast<float>(total[0]), nb);
  float mu0 = weighted_mean(total[1], total[3], mu);
  float mu1 = weighted_mean(total[2], total[4], mu);
  variance_pass<kWeighted, true>(xb, wb, N, p, cut, mu0, mu1, acc1);
  block_sum(acc1, scratch, total);
  p = make_params(mu0, mu1, __fdiv_rn(static_cast<float>(total[0]), nb), pi0[lane]);
  sums_pass<kWeighted, false>(xb, wb, N, p, cut, acc);
  block_sum(acc, scratch, total);
  float logp = __fadd_rn(__fmul_rn(scale, static_cast<float>(total[0])),
                         beta_logpdf(p.pi, alpha, beta, betaln));
  float logp_cur = logp;

  // the loop, uniform across the block: every thread holds the same state
  int it = 0;
  bool done = false;
  while (it < num_iters && !done) {
    const double s0 = total[1], s1 = total[2], x0 = total[3], x1 = total[4];
    const float a = __fadd_rn(alpha, static_cast<float>(s1));
    const float bb = __fsub_rn(__fadd_rn(beta, nb), static_cast<float>(s1));
    const float pi = __fdiv_rn(__fsub_rn(a, 1.0f), __fsub_rn(__fadd_rn(a, bb), 2.0f));
    mu0 = weighted_mean(s0, x0, mu);
    mu1 = weighted_mean(s1, x1, mu);
    variance_pass<kWeighted, false>(xb, wb, N, p, cut, mu0, mu1, acc1);
    block_sum(acc1, scratch, total);
    p = make_params(mu0, mu1, __fdiv_rn(static_cast<float>(total[0]), nb), pi);
    sums_pass<kWeighted, false>(xb, wb, N, p, cut, acc);
    block_sum(acc, scratch, total);
    logp = __fadd_rn(__fmul_rn(scale, static_cast<float>(total[0])),
                     beta_logpdf(pi, alpha, beta, betaln));
    done = __fsub_rn(logp, logp_cur) <= tol;
    if (!done) logp_cur = logp;
    ++it;
  }

  if (threadIdx.x == 0) {
    out[0 * lanes + lane] = logp;
    out[1 * lanes + lane] = p.mu0;
    out[2 * lanes + lane] = p.var;
    out[3 * lanes + lane] = p.mu1;
    out[4 * lanes + lane] = p.var;
    out[5 * lanes + lane] = p.pi;
    steps[lane] = it;
  }
}

}  // namespace

// x (B, N), w (B, N) or null, n (B,), pi and split (B, L), all float32 and
// contiguous on the device; out (6, B, L) float32 and steps (B, L) int32.
// Returns the launch's CUDA error code (0 on success); it does not wait for
// the fit to end.
extern "C" int gmm_em_f32(const void* x, const void* w, const void* n, const void* pi,
                          const void* split, int B, int N, int L, float alpha, float beta,
                          float scale, float tol, int num_iters, float betaln, void* out,
                          void* steps, void* stream) {
  if (B < 0 || L < 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = static_cast<long long>(B) * L;
  if (lanes == 0) return 0;
  if (lanes > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(lanes));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* nf = static_cast<const float*>(n);
  const auto* pf = static_cast<const float*>(pi);
  const auto* sf = static_cast<const float*>(split);
  auto* of = static_cast<float*>(out);
  auto* st = static_cast<int*>(steps);
  if (wf)
    gmm_em<true><<<grid, kThreads, 0, s>>>(xf, wf, nf, pf, sf, N, L, static_cast<int>(lanes),
                                           alpha, beta, scale, tol, num_iters, betaln, of, st);
  else
    gmm_em<false><<<grid, kThreads, 0, s>>>(xf, wf, nf, pf, sf, N, L, static_cast<int>(lanes),
                                            alpha, beta, scale, tol, num_iters, betaln, of, st);
  return static_cast<int>(cudaGetLastError());
}
