// EM of the GMM normalization for Hopper (sm_90a): every (image, lane) fit
// of a call runs to its end in one launch, each lane over a thread-block
// cluster.
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
// Design. A lane runs over a thread-block cluster of C blocks (2 <= C <=
// 16, on neighbouring SMs of one GPC); rank r of the cluster owns the fixed
// slice [r S, (r + 1) S) of the image's pixels, S = ceil(N / C). Each
// thread keeps float64 partial sums of a fixed stride of its block's slice;
// the block reduces them by warp shuffles and then across warps, and after
// a cluster barrier K x C threads read the C blocks' partials through
// distributed shared memory, one each, and thread k adds partial k of ranks
// 0..C-1 in that order. So every block of the cluster holds the same
// totals, takes the same scalar update and the same stop, and a fit is the
// same from run to run. The partials are double-buffered by reduction, so
// that one cluster barrier a reduction suffices: a block writes a buffer
// again only after the next barrier, which every peer reaches after reading
// it. A last barrier keeps each block resident until its peers have read
// it. The grid is lane-major (cluster q = l B + b), so that the lanes of
// small pi, which run longest on micrographs, start first.
//
// A step needs the responsibilities at the old parameters (for the
// variance at the new means) and one posterior evaluation at the new ones
// (for sum w Z and the next step's sums of p0, p1, x p0 and x p1). Each
// block keeps the weighted p0 and p1 of the first `kept` pixels of its
// slice in its shared memory (8 bytes a pixel, up to ~28,800 pixels),
// the same floats the evaluation computed, and the variance pass reads
// them; it evaluates the others' again. Where a block keeps its whole slice
// (the resident route: 512^2 at C >= 10, 768 x 512 at C >= 14, a 65536-bin
// histogram at C >= 3) a step is one evaluation a pixel; where it does not
// (the recompute route: a 4096^2 micrograph fit whole, or a smaller C that
// more clusters can run at once), it is two for the pixels beyond `kept`.
// ops/gmm._em_plan chooses C and `kept` from the card's shared memory and
// the clusters it holds at once (gmm_em_max_clusters); the launch takes
// both. x and w are read from L2 (or device memory) every pass.
//
// Bound. Each step evaluates the posteriors once a pixel and lane: five
// transcendental functions (two exp and a log for Z, two exp for p0 and
// p1) and ~29 float32 operations; x and w are read once, 8 bytes a pixel.
// With the 16 MUFU results a clock an SM of compute capability 9.0, a fit
// of the 512 x 512 x 8 bucket is MUFU-bound by far: ~28 us a step for all
// 88 lanes, against 5 us to read the 16 MB once. What sets the kernel's
// pace is instruction issue, not MUFU: the evaluation loop's SASS holds
// ~130 instructions a pixel (tools/profile_torch_gmm_em.py counts them),
// of which 6 are MUFU (four exp2 and the two divisions' reciprocals; logf
// and log1pf are FMA polynomials), 5 conversions to float64 and 5 float64
// adds, each IEEE division ~11 with its check and branch: 1.0 clock a pixel
// at 128 issued a clock an SM, against 0.38 for MUFU and 0.31 for the
// conversions. On an H100 an evaluation takes ~0.54 ns a pixel on one SM,
// and a step ~5.5 us more (two cluster reductions and the passes' last
// latencies; ~8 us at C = 16). PERF.md has the measured times beside the
// bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
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

// torch.maximum: NaN when either side is NaN (selects, not branches)
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
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

// Sums every thread's K partial sums over the cluster, in a fixed order,
// into total[K]: warp shuffles, then across the block's warps into this
// block's `partial`; after a cluster barrier, K x C threads each read one
// block's partial through distributed shared memory into `gathered`, and
// thread k adds the C blocks' partials k in rank order. On return every
// thread may read total.
template <int K>
__device__ __forceinline__ void cluster_sum(double (&v)[K], double* scratch, double* partial,
                                            double* gathered, double* total,
                                            cg::cluster_group& cluster, int C) {
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
      if (lane == 0) partial[k] = t;
    }
  }
  cluster.sync();
  if (threadIdx.x < K * C) {
    const int k = threadIdx.x / C, r = threadIdx.x - k * C;
    gathered[threadIdx.x] = cluster.map_shared_rank(partial, r)[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const double* g = gathered + threadIdx.x * C;
    double t = g[0];
    for (int r = 1; r < C; ++r) t += g[r];
    total[threadIdx.x] = t;
  }
  __syncthreads();
}

// sum x w (kHard only, else sum w Z at `p`), sum p0, sum p1, sum x p0 and
// sum x p1 of this thread's pixels of the block's slice (`count` pixels);
// the weighted p0 and p1 of the first `kept` pixels go to keep[i]
template <bool kWeighted, bool kHard>
__device__ __forceinline__ void sums_pass(const float* __restrict__ x, const float* __restrict__ w,
                                          int count, const Params& p, float split,
                                          double (&acc)[5], float2* __restrict__ keep, int kept) {
#pragma unroll
  for (int k = 0; k < 5; ++k) acc[k] = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < count; i += kThreads) {
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
      if (i < kept) keep[i] = make_float2(p0, p1);
    }
    acc[1] += static_cast<double>(p0);
    acc[2] += static_cast<double>(p1);
    acc[3] += static_cast<double>(__fmul_rn(xi, p0));
    acc[4] += static_cast<double>(__fmul_rn(xi, p1));
  }
}

// p0 (x - mu0)^2 + p1 (x - mu1)^2 of one pixel
__device__ __forceinline__ double spread(float x, float p0, float p1, float mu0, float mu1) {
  const float d0 = __fsub_rn(x, mu0);
  const float d1 = __fsub_rn(x, mu1);
  return static_cast<double>(
      __fadd_rn(__fmul_rn(p0, __fmul_rn(d0, d0)), __fmul_rn(p1, __fmul_rn(d1, d1))));
}

// sum p0 (x - mu0)^2 + p1 (x - mu1)^2 of this thread's pixels: those below
// `kept` with the responsibilities the last sums_pass kept, the others with
// those of the init's split or of the parameters `p`
template <bool kWeighted, bool kHard>
__device__ __forceinline__ void variance_pass(const float* __restrict__ x,
                                              const float* __restrict__ w, int count,
                                              const Params& p, float split, float mu0, float mu1,
                                              double (&acc)[1], const float2* __restrict__ keep,
                                              int kept) {
  acc[0] = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < kept; i += kThreads) {
    const float2 k = keep[i];
    acc[0] += spread(x[i], k.x, k.y, mu0, mu1);
  }
#pragma unroll 4
  for (int i = kept + threadIdx.x; i < count; i += kThreads) {
    const float xi = x[i];
    float p0, p1;
    responsibilities<kHard>(xi, kWeighted ? w[i] : 1.0f, p, split, p0, p1);
    acc[0] += spread(xi, p0, p1, mu0, mu1);
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

// One cluster of C blocks an (image, lane) pair: cluster q = l * B + b,
// block rank r owns pixels [r slice, (r + 1) slice) of image b and keeps the
// responsibilities of its first `kept` pixels in its dynamic shared memory
// (8 B a pixel) from each evaluation to the next step's variance.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads, 1)
gmm_em(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ n,
       const float* __restrict__ pi0, const float* __restrict__ split, int N, int B, int L,
       int slice, int kept, float alpha, float beta, float scale, float tol, int num_iters,
       float betaln, float* __restrict__ out, int* __restrict__ steps) {
  extern __shared__ float2 keep[];
  __shared__ double scratch[5 * kWarps];
  __shared__ double partials[2][5];
  __shared__ double gathered[5 * kMaxCluster];
  __shared__ double total[5];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = static_cast<int>(blockIdx.x) / C;
  const int b = q % B;
  const int lane = b * L + q / B;
  const long long begin = min(static_cast<long long>(rank) * slice, static_cast<long long>(N));
  const int count = static_cast<int>(min(begin + slice, static_cast<long long>(N)) - begin);
  const int kept_here = min(kept, count);
  const float* xb = x + static_cast<size_t>(b) * N + begin;
  const float* wb = kWeighted ? w + static_cast<size_t>(b) * N + begin : nullptr;
  const float nb = n[b];
  const float cut = split[lane];
  double acc[5];
  double acc1[1];
  int red = 0;  // reductions so far: the parity picks the partials' buffer

  // init: the hard split at `cut`
  Params p = make_params(0.0f, 0.0f, 1.0f, 0.5f);  // unread by the hard passes
  sums_pass<kWeighted, true>(xb, wb, count, p, cut, acc, keep, 0);
  cluster_sum(acc, scratch, partials[red++ & 1], gathered, total, cluster, C);
  const float mu = __fdiv_rn(static_cast<float>(total[0]), nb);
  float mu0 = weighted_mean(total[1], total[3], mu);
  float mu1 = weighted_mean(total[2], total[4], mu);
  variance_pass<kWeighted, true>(xb, wb, count, p, cut, mu0, mu1, acc1, keep, 0);
  cluster_sum(acc1, scratch, partials[red++ & 1], gathered, total, cluster, C);
  p = make_params(mu0, mu1, __fdiv_rn(static_cast<float>(total[0]), nb), pi0[lane]);
  sums_pass<kWeighted, false>(xb, wb, count, p, cut, acc, keep, kept_here);
  cluster_sum(acc, scratch, partials[red++ & 1], gathered, total, cluster, C);
  float logp = __fadd_rn(__fmul_rn(scale, static_cast<float>(total[0])),
                         beta_logpdf(p.pi, alpha, beta, betaln));
  float logp_cur = logp;

  // the loop, uniform across the cluster: every thread of its blocks holds
  // the same state
  int it = 0;
  bool done = false;
  while (it < num_iters && !done) {
    const double s0 = total[1], s1 = total[2], x0 = total[3], x1 = total[4];
    const float a = __fadd_rn(alpha, static_cast<float>(s1));
    const float bb = __fsub_rn(__fadd_rn(beta, nb), static_cast<float>(s1));
    const float pi = __fdiv_rn(__fsub_rn(a, 1.0f), __fsub_rn(__fadd_rn(a, bb), 2.0f));
    mu0 = weighted_mean(s0, x0, mu);
    mu1 = weighted_mean(s1, x1, mu);
    variance_pass<kWeighted, false>(xb, wb, count, p, cut, mu0, mu1, acc1, keep, kept_here);
    cluster_sum(acc1, scratch, partials[red++ & 1], gathered, total, cluster, C);
    p = make_params(mu0, mu1, __fdiv_rn(static_cast<float>(total[0]), nb), pi);
    sums_pass<kWeighted, false>(xb, wb, count, p, cut, acc, keep, kept_here);
    cluster_sum(acc, scratch, partials[red++ & 1], gathered, total, cluster, C);
    logp = __fadd_rn(__fmul_rn(scale, static_cast<float>(total[0])),
                     beta_logpdf(pi, alpha, beta, betaln));
    done = __fsub_rn(logp, logp_cur) <= tol;
    if (!done) logp_cur = logp;
    ++it;
  }

  if (rank == 0 && threadIdx.x == 0) {
    const int lanes = B * L;
    out[0 * lanes + lane] = logp;
    out[1 * lanes + lane] = p.mu0;
    out[2 * lanes + lane] = p.var;
    out[3 * lanes + lane] = p.mu1;
    out[4 * lanes + lane] = p.var;
    out[5 * lanes + lane] = p.pi;
    steps[lane] = it;
  }
  // no block retires while a peer may still read its partials
  cluster.sync();
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, int,
                        int, int, int, int, float, float, float, float, int, float, float*, int*);

Kernel kernel_of(bool weighted) { return weighted ? gmm_em<true> : gmm_em<false>; }

// The dynamic shared memory a block of the current device may take beside
// the kernel's static shared memory.
cudaError_t dynamic_smem_limit(Kernel f, int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, f);
  if (e == cudaSuccess) *bytes = optin - static_cast<int>(attr.sharedSizeBytes);
  return e;
}

// Lets `f` take all of that dynamic shared memory and, where the card
// allows them, clusters of up to 16 blocks; a card that refuses sizes
// above 8 holds no cluster of them (gmm_em_max_clusters). The values do not
// depend on the launch, so threads that launch on one device at once set
// the same ones.
cudaError_t prepare(Kernel f) {
  int limit = 0;
  cudaError_t e = dynamic_smem_limit(f, &limit);
  if (e == cudaSuccess && cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
    cudaGetLastError();
  if (e == cudaSuccess) e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  return e;
}

void launch_config(cudaLaunchConfig_t* config, cudaLaunchAttribute* attr, unsigned grid, int C,
                   long long smem, cudaStream_t stream) {
  *config = {};
  config->gridDim = dim3(grid);
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = static_cast<size_t>(smem);
  config->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
}

// pixels of a rank's slice
int slice_of(int N, int C) { return static_cast<int>((static_cast<long long>(N) + C - 1) / C); }

}  // namespace

// The dynamic shared memory a block of the kernel may take on the current
// device (bytes), into *bytes. Returns a CUDA error code (0 on success).
extern "C" int gmm_em_smem_limit(int* bytes) {
  return static_cast<int>(dynamic_smem_limit(kernel_of(false), bytes));
}

// How many clusters of C blocks of the kernel (with weights or without),
// each block with `smem` bytes of dynamic shared memory, the current device
// holds at once (cudaOccupancyMaxActiveClusters), into *count: 0 for a
// size above 8 that the card refuses. Returns a CUDA error code (0 on
// success).
extern "C" int gmm_em_max_clusters(int weighted, int C, int smem, int* count) {
  if (C < 1 || C > kMaxCluster || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel f = kernel_of(weighted != 0);
  cudaError_t e = prepare(f);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  launch_config(&config, &attr, static_cast<unsigned>(C), C, smem, nullptr);
  e = cudaOccupancyMaxActiveClusters(count, f, &config);
  if (e != cudaSuccess && C > 8) {
    cudaGetLastError();
    *count = 0;
    return 0;
  }
  return static_cast<int>(e);
}

// x (B, N), w (B, N) or null, n (B,), pi and split (B, L), all float32 and
// contiguous on the device; out (6, B, L) float32 and steps (B, L) int32.
// Each of the B L lanes runs over a cluster of C blocks, and each block
// keeps the responsibilities of the first `kept` pixels of its slice in
// 8 kept bytes of shared memory (ops/gmm._em_plan chooses both). Returns
// the launch's CUDA error code (0 on success); it does not wait for the fit
// to end.
extern "C" int gmm_em_f32(const void* x, const void* w, const void* n, const void* pi,
                          const void* split, int B, int N, int L, int C, int kept,
                          float alpha, float beta, float scale, float tol, int num_iters,
                          float betaln, void* out, void* steps, void* stream) {
  if (B < 0 || L < 0 || N <= 0 || C < 1 || C > kMaxCluster || kept < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = static_cast<long long>(B) * L;
  if (lanes == 0) return 0;
  const int slice = slice_of(N, C);
  if (lanes * C > 0x7fffffffLL || kept > slice) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel f = kernel_of(w != nullptr);
  cudaError_t e = prepare(f);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  launch_config(&config, &attr, static_cast<unsigned>(lanes * C), C,
                static_cast<long long>(kept) * static_cast<long long>(sizeof(float2)),
                static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&config, f, static_cast<const float*>(x), static_cast<const float*>(w),
                         static_cast<const float*>(n), static_cast<const float*>(pi),
                         static_cast<const float*>(split), N, B, L, slice, kept, alpha, beta,
                         scale, tol, num_iters, betaln, static_cast<float*>(out),
                         static_cast<int*>(steps));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
