// The passes between the U-Net's convolutions, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package left this glue to XLA, which
// fuses a convolution's bias, activation and pooling into its neighbours.
// PyTorch runs it as separate memory passes after each cuDNN convolution:
// the bias add, LeakyReLU, MaxPool, one index_select an axis for the
// nearest upsample and the concat, each reading and writing every
// activation. Here each edge between two convolutions is one pass that
// reads the convolution's raw output once and writes the next
// convolution's input once. Tensors are NC + 2 or 3 spatial axes,
// contiguous float32; 2D runs as D = 1.
//
//   unet_bias_lrelu        in place: y = x + b[c]; y > 0 ? y : y * 0.1
//                          (the activation optional: the last layer's bias)
//   unet_bias_lrelu_pool   the same, then the VALID 2x (2^3 in 3D) max with
//                          odd sizes floored; only the pooled map is written
//   unet_bias_lrelu_up_cat the same on a level's low-resolution output (C1
//                          channels), upsampled nearest and written with its
//                          skip (C2 channels, 0 where the level has none)
//                          into the next convolution's (N, C1 + C2, *S) input
//
// Exactness. Every float operation is the one PyTorch's path does, in its
// order: the add (ATen's `output.add_(bias)` after cuDNN), the compare and
// scale of leaky_relu, the max of max_pool with its NaN rule (a NaN wins)
// and its window order (z, then y, then x, a strict `>`, so the first of
// equal values stays, as a -0.0 before a +0.0), and copies. The add and the
// scale are rounded on their own (__fadd_rn, __fmul_rn), never contracted.
// The nearest source index is the integer rule (j * n_in) / n_out of
// models/denoise.nearest_index on every axis, not j / 2, so odd sizes stay
// right. So the U-Net's output is bit-equal to the modules' on the card.
//
// Bound. Bytes: one read of each input float and one write of each output
// float (a few bias values aside); no arithmetic worth the name. Design for
// that: 128-bit loads and stores along the innermost axis where its extent
// is a multiple of 4 (and the pointers 16-byte aligned), else one float a
// thread. A block works on one (n, c) plane at a time, so its bias and its
// branch (upsample or skip) are uniform and no thread divides by C; the
// grid covers a plane in 256-thread blocks and loops over the planes past
// 65535, which puts tens of thousands of blocks on the 132 SMs at the main
// paths' sizes. One thread owns: a float4 (bias_lrelu); a 2 x 4 (2 x 2 x 4)
// input patch and its two outputs (pool); four output columns in each of a
// few rows (upsample), whose sources it reads as scalars through L1, a
// source value read once from memory and again from cache, or a float4 of
// the skip in each of those rows.
//
// Launches go on the caller's stream, synchronise nothing and allocate
// nothing; each entry returns cudaGetLastError() after its launch. Indices
// inside a plane are 32-bit: the wrapper refuses planes of 2^31 values or
// more and upsample extents above 65535 (so j * n_in fits 32 bits).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535;
constexpr unsigned kRowsPerThread = 8;
constexpr float kLeak = 0.1f;

__device__ __forceinline__ float bias_act(float x, float b, bool leaky) {
  const float y = __fadd_rn(x, b);
  return (!leaky || y > 0.f) ? y : __fmul_rn(y, kLeak);
}

// max_pool's step: a larger value or a NaN (v != v) replaces the running max
__device__ __forceinline__ float pool_step(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// source index of output position j of a nearest resize from n_in to n_out;
// where n_out = 2 n_in (every axis of an even-sized U-Net) the integer rule
// is floor(j / 2), the same integer, without a division
__device__ __forceinline__ unsigned src_index(unsigned j, unsigned n_in, unsigned n_out) {
  return n_out == 2 * n_in ? j >> 1 : j * n_in / n_out;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bias_lrelu_kernel(float* x, const float* __restrict__ bias, unsigned C, unsigned planes,
                  unsigned S, bool leaky) {
  const unsigned n = kVec ? S / 4 : S;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned p = blockIdx.y; p < planes; p += gridDim.y) {
    const float b = bias[p % C];
    float* plane = x + static_cast<size_t>(p) * S;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      if (kVec) {
        float4 v = reinterpret_cast<const float4*>(plane)[i];
        v.x = bias_act(v.x, b, leaky);
        v.y = bias_act(v.y, b, leaky);
        v.z = bias_act(v.z, b, leaky);
        v.w = bias_act(v.w, b, leaky);
        reinterpret_cast<float4*>(plane)[i] = v;
      } else {
        plane[i] = bias_act(plane[i], b, leaky);
      }
    }
  }
}

// kz = 2 pools z (3D), 1 leaves it (2D: D = Do = 1); an odd extent drops
// its last row, column or slice. The vector route (W % 4 == 0, so Wo = W / 2
// is even) gives a thread two outputs from a 2 x 4 patch of each of its kz
// input slices.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bias_lrelu_pool_kernel(const float* __restrict__ in, const float* __restrict__ bias,
                       float* __restrict__ out, unsigned C, unsigned planes, int kz,
                       unsigned D, unsigned H, unsigned W, unsigned Do, unsigned Ho,
                       unsigned Wo) {
  const unsigned Q = kVec ? Wo / 2 : Wo;  // items of an output row
  const unsigned n = Do * Ho * Q;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned p = blockIdx.y; p < planes; p += gridDim.y) {
    const float b = bias[p % C];
    const float* src = in + static_cast<size_t>(p) * (D * H * W);
    float* dst = out + static_cast<size_t>(p) * (Do * Ho * Wo);
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      const unsigned q = i % Q, r = i / Q;
      const unsigned oy = Do == 1 ? r : r % Ho, oz = Do == 1 ? 0 : r / Ho;
      if (kVec) {
        float m0 = -INFINITY, m1 = -INFINITY;
        for (int dz = 0; dz < kz; ++dz) {
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const float4 v = *reinterpret_cast<const float4*>(
                src + (static_cast<size_t>(kz * oz + dz) * H + 2 * oy + dy) * W + 4 * q);
            m0 = pool_step(m0, bias_act(v.x, b, true));
            m0 = pool_step(m0, bias_act(v.y, b, true));
            m1 = pool_step(m1, bias_act(v.z, b, true));
            m1 = pool_step(m1, bias_act(v.w, b, true));
          }
        }
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * Wo + 2 * q) =
            make_float2(m0, m1);
      } else {
        float m = -INFINITY;
        for (int dz = 0; dz < kz; ++dz)
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              m = pool_step(m, bias_act(
                  src[(static_cast<size_t>(kz * oz + dz) * H + 2 * oy + dy) * W + 2 * q + dx],
                  b, true));
        dst[static_cast<size_t>(r) * Wo + q] = m;
      }
    }
  }
}

// Plane p of the output is channel p % (C1 + C2) of image p / (C1 + C2):
// below C1 the upsampled activation, from there the skip. A thread owns an
// item of every row it visits: four output columns on the vector route
// (Wo % 4 == 0), else one. Its source columns are the same in every row,
// so it finds them once; a row costs it one source row and, in 3D, one
// division. (A flat index, divided down to its column, row and slice for
// each item, held this pass to 0.52-0.58 of its bound: the divisions, not
// the bytes, were the limit.) Grid: x the items of a row, y the rows in
// steps of gridDim.y * blockDim.y, z the planes in steps of gridDim.z.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bias_lrelu_up_cat_kernel(const float* __restrict__ h, const float* __restrict__ bias,
                         const float* __restrict__ skip, float* __restrict__ out, unsigned C1,
                         unsigned C2, unsigned planes, unsigned Di, unsigned Hi, unsigned Wi,
                         unsigned Do, unsigned Ho, unsigned Wo) {
  constexpr int kItem = kVec ? 4 : 1;
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Wo / kItem) return;
  const unsigned C = C1 + C2;
  const unsigned x = kItem * q, rows = Do * Ho, So = rows * Wo, Si = Di * Hi * Wi;
  unsigned sx[kItem];
#pragma unroll
  for (int k = 0; k < kItem; ++k) sx[k] = src_index(x + k, Wi, Wo);
  for (unsigned p = blockIdx.z; p < planes; p += gridDim.z) {
    const unsigned img = p / C, c = p % C;
    float* dst = out + static_cast<size_t>(p) * So + x;
    if (c < C1) {
      const float b = bias[c];
      const float* src = h + (static_cast<size_t>(img) * C1 + c) * Si;
      for (unsigned r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
           r += gridDim.y * blockDim.y) {
        const unsigned oy = Do == 1 ? r : r % Ho, oz = Do == 1 ? 0 : r / Ho;
        const float* row = src + (static_cast<size_t>(src_index(oz, Di, Do)) * Hi +
                                  src_index(oy, Hi, Ho)) * Wi;
        if constexpr (kVec) {
          float4 v;
          v.x = bias_act(row[sx[0]], b, true);
          v.y = bias_act(row[sx[1]], b, true);
          v.z = bias_act(row[sx[2]], b, true);
          v.w = bias_act(row[sx[3]], b, true);
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * Wo) = v;
        } else {
          dst[static_cast<size_t>(r) * Wo] = bias_act(row[sx[0]], b, true);
        }
      }
    } else {
      const float* src = skip + (static_cast<size_t>(img) * C2 + (c - C1)) * So + x;
      for (unsigned r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
           r += gridDim.y * blockDim.y) {
        if constexpr (kVec)
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * Wo) =
              *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * Wo);
        else
          dst[static_cast<size_t>(r) * Wo] = src[static_cast<size_t>(r) * Wo];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

dim3 grid_for(unsigned items, unsigned planes) {
  const unsigned blocks = items == 0 ? 1 : (items + kThreads - 1) / kThreads;
  return dim3(blocks, planes < kMaxGridY ? planes : kMaxGridY);
}

// a plane's values, or a tensor's planes, below 2^31: 32-bit indices
bool fits(long long n) { return n > 0 && n < INT_MAX; }

}  // namespace

extern "C" int unet_bias_lrelu(void* x, const void* bias, int N, int C, long long S,
                               int leaky, void* stream) {
  const long long planes = static_cast<long long>(N) * C;
  if (N <= 0 || C <= 0 || !fits(S) || !fits(planes))
    return static_cast<int>(cudaErrorInvalidValue);
  float* xp = static_cast<float*>(x);
  const float* bp = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned s = static_cast<unsigned>(S), np = static_cast<unsigned>(planes);
  if (s % 4 == 0 && aligned16(xp))
    bias_lrelu_kernel<true><<<grid_for(s / 4, np), kThreads, 0, st>>>(xp, bp, C, np, s,
                                                                      leaky != 0);
  else
    bias_lrelu_kernel<false><<<grid_for(s, np), kThreads, 0, st>>>(xp, bp, C, np, s,
                                                                   leaky != 0);
  return static_cast<int>(cudaGetLastError());
}

// in (N, C, D, H, W) -> out (N, C, D / 2 or D, H / 2, W / 2); pool_z = 0 in
// 2D (D = 1)
extern "C" int unet_bias_lrelu_pool(const void* in, const void* bias, void* out, int N, int C,
                                    int D, int H, int W, int pool_z, void* stream) {
  const int kz = pool_z ? 2 : 1;
  const int Do = D / kz, Ho = H / 2, Wo = W / 2;
  const long long planes = static_cast<long long>(N) * C;
  if (N <= 0 || C <= 0 || Do <= 0 || Ho <= 0 || Wo <= 0 || !fits(planes) ||
      !fits(static_cast<long long>(D) * H * W))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ip = static_cast<const float*>(in);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned np = static_cast<unsigned>(planes);
  const bool vec = W % 4 == 0 && aligned16(ip) && aligned16(op);
  const unsigned items = static_cast<unsigned>(Do) * Ho * (vec ? Wo / 2 : Wo);
  if (vec)
    bias_lrelu_pool_kernel<true><<<grid_for(items, np), kThreads, 0, st>>>(
        ip, bp, op, C, np, kz, D, H, W, Do, Ho, Wo);
  else
    bias_lrelu_pool_kernel<false><<<grid_for(items, np), kThreads, 0, st>>>(
        ip, bp, op, C, np, kz, D, H, W, Do, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unet_bias_lrelu_up_cat(const void* h, const void* bias, const void* skip,
                                      void* out, int N, int C1, int C2, int Di, int Hi, int Wi,
                                      int Do, int Ho, int Wo, void* stream) {
  const int ext[6] = {Di, Hi, Wi, Do, Ho, Wo};
  for (int e : ext)
    if (e <= 0 || e > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long planes = static_cast<long long>(N) * (static_cast<long long>(C1) + C2);
  if (N <= 0 || C1 <= 0 || C2 < 0 || (C2 > 0 && skip == nullptr) || !fits(planes) ||
      !fits(static_cast<long long>(Di) * Hi * Wi) || !fits(static_cast<long long>(Do) * Ho * Wo))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* hp = static_cast<const float*>(h);
  const float* bp = static_cast<const float*>(bias);
  const float* sp = static_cast<const float*>(skip);
  float* op = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned np = static_cast<unsigned>(planes);
  const bool vec = Wo % 4 == 0 && aligned16(op) && (C2 == 0 || aligned16(sp));
  // a block of 256 threads: as many of a row's items as round up to a power
  // of two (32 to 256), and the rest of the block on the next rows; about
  // kRowsPerThread rows a thread
  const unsigned items = vec ? Wo / 4 : Wo;
  unsigned bx = 32;
  while (bx < items && bx < kThreads) bx *= 2;
  const dim3 block(bx, kThreads / bx);
  const unsigned rows = static_cast<unsigned>(Do) * Ho;
  const unsigned gy = (rows + block.y * kRowsPerThread - 1) / (block.y * kRowsPerThread);
  const dim3 grid((items + bx - 1) / bx, gy < kMaxGridY ? gy : kMaxGridY,
                  np < kMaxGridY ? np : kMaxGridY);
  if (vec)
    bias_lrelu_up_cat_kernel<true><<<grid, block, 0, st>>>(hp, bp, sp, op, C1, C2, np, Di, Hi,
                                                           Wi, Do, Ho, Wo);
  else
    bias_lrelu_up_cat_kernel<false><<<grid, block, 0, st>>>(hp, bp, sp, op, C1, C2, np, Di,
                                                            Hi, Wi, Do, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}
