// Disk max-filter for greedy non-maximum suppression, for Hopper (sm_90a).
//
// Replaces the TPU kernel _disk_max_kernel / disk_max_pallas
// (topaz_tpu/ops/nms_pallas.py:35-119). For every pixel of a (B, H, W)
// image stack:
//
//     out[b, y, x] = max over dy^2 + dx^2 <= r^2 of in[b, y + dy, x + dx]
//
// where a tap outside the image reads `init` (-inf for scores, INT32_MIN for
// the index and peak maps of the NMS rounds). chords[dy + r] is the chord
// half-width floor(sqrt(r^2 - dy^2)); the host computes it exactly as
// ops/nms._chords_2d does, so no device sqrt can round a chord differently.
//
// Bound: memory. The function reads the image once and writes it once,
// 8 bytes a pixel: 2 MB at the main path's 512 x 512, about 0.6 us at
// 3.35 TB/s. At that size the kernel stays well above it: one block per
// tile leaves 256 blocks for 132 SMs, and each chord width costs two
// block-wide barriers (PERF.md has the measured time).
//
// Design: one block of 32 x 8 threads per 32 x 32 output tile. The block
// stages the tile and an r-wide halo (init outside the image) in shared
// memory. Then, as the TPU kernel does, it builds the horizontal chord
// maxima incrementally, m_w = max(m_{w-1}, x[-w], x[+w]) for w = 1..r, in a
// shared (32 + 2r) x 32 buffer, and each time w is the half-width of the
// chords at +-dy it folds row dy of that buffer into the outputs, which each
// thread keeps in registers (four pixels of one column). That is about
// 3 * (r + 1) * (32 + 2r) / 32 + (2r + 1) shared-memory accesses a pixel
// instead of the disk's ~pi r^2 taps. The TPU kernel's 256^2 tile and
// (8, 128) halo rounding were TPU tiling and are not carried over. When the
// window does not fit in shared memory (r > 96 for 4-byte types) a second
// kernel takes the max over each chord's row segment straight from device
// memory through the cache instead.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kBlockRows = 8;
constexpr int kRowsPerThread = kTile / kBlockRows;
constexpr int kThreads = kTile * kBlockRows;

// NaN-propagating max, as torch.maximum and jnp.maximum.
__device__ __forceinline__ float take_max(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__device__ __forceinline__ int take_max(int acc, int v) {
  return v > acc ? v : acc;
}

// The chord table padded to 16 bytes, so the tiles after it stay aligned.
__host__ __device__ __forceinline__ int chord_slots(int r) {
  return (2 * r + 1 + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
disk_max_shared(const T* __restrict__ in, T* __restrict__ out,
                const int* __restrict__ chords, int H, int W, int r, T init) {
  extern __shared__ int smem[];
  const int S = kTile + 2 * r;  // window side
  int* chord = smem;
  T* win = reinterpret_cast<T*>(smem + chord_slots(r));  // S x S
  T* hmax = win + S * S;  // S x kTile: chord maxima of the current width

  const size_t plane = static_cast<size_t>(H) * W;
  const T* img = in + blockIdx.z * plane;
  T* dst = out + blockIdx.z * plane;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int tx = threadIdx.x;

  for (int i = tid; i < 2 * r + 1; i += kThreads) chord[i] = chords[i];
  for (int i = tid; i < S * S; i += kThreads) {
    const int wy = i / S;
    const int wx = i - wy * S;
    const int gy = y0 - r + wy;
    const int gx = x0 - r + wx;
    win[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? img[static_cast<size_t>(gy) * W + gx]
                 : init;
  }
  __syncthreads();
  // width 0: the column itself
  for (int i = tid; i < S * kTile; i += kThreads)
    hmax[i] = win[(i / kTile) * S + (i % kTile) + r];
  __syncthreads();

  T acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = init;

  // chord(k) never grows with |k|, so as w rises the rows it serves are
  // k = r, r-1, ..., 0 in order
  int k = r;
  for (int w = 0; w <= r && k >= 0; ++w) {
    if (w > 0) {
      __syncthreads();  // every fold of width w - 1 has read hmax
      for (int i = tid; i < S * kTile; i += kThreads) {
        const T* row = win + (i / kTile) * S + (i % kTile) + r;
        hmax[i] = take_max(hmax[i], take_max(row[-w], row[w]));
      }
      __syncthreads();
    }
    for (; k >= 0 && chord[r + k] == w; --k) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int ty = threadIdx.y + j * kBlockRows;
        acc[j] = take_max(acc[j], hmax[(ty + r + k) * kTile + tx]);
        if (k > 0) acc[j] = take_max(acc[j], hmax[(ty + r - k) * kTile + tx]);
      }
    }
  }

  const int gx = x0 + tx;
  if (gx >= W) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int gy = y0 + threadIdx.y + j * kBlockRows;
    if (gy < H) dst[static_cast<size_t>(gy) * W + gx] = acc[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
disk_max_global(const T* __restrict__ in, T* __restrict__ out,
                const int* __restrict__ chords, int H, int W, int r, T init) {
  const size_t plane = static_cast<size_t>(H) * W;
  const T* img = in + blockIdx.z * plane;
  T* dst = out + blockIdx.z * plane;
  const int gx = blockIdx.x * kTile + threadIdx.x;
  if (gx >= W) return;
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int gy = blockIdx.y * kTile + threadIdx.y + j * kBlockRows;
    if (gy >= H) return;
    T acc = init;
    for (int dy = -r; dy <= r; ++dy) {
      const int w = __ldg(chords + dy + r);
      const int sy = gy + dy;
      const int lo = gx - w;
      const int hi = gx + w;
      if (sy < 0 || sy >= H || lo < 0 || hi >= W) acc = take_max(acc, init);
      if (sy < 0 || sy >= H) continue;
      const T* row = img + static_cast<size_t>(sy) * W;
      const int a = lo < 0 ? 0 : lo;
      const int b = hi >= W ? W - 1 : hi;
      for (int sx = a; sx <= b; ++sx) acc = take_max(acc, __ldg(row + sx));
    }
    dst[static_cast<size_t>(gy) * W + gx] = acc;
  }
}

template <typename T>
int launch(const T* in, T* out, const int* chords, int B, int H, int W, int r,
           T init, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || r < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t side = static_cast<size_t>(kTile) + 2 * static_cast<size_t>(r);
  const size_t shared_bytes = chord_slots(r) * sizeof(int) +
                              (side * side + side * kTile) * sizeof(T);
  const dim3 block(kTile, kBlockRows);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);

  if (shared_bytes <= static_cast<size_t>(max_optin)) {
    err = cudaFuncSetAttribute(disk_max_shared<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    disk_max_shared<T><<<grid, block, shared_bytes, stream>>>(
        in, out, chords, H, W, r, init);
  } else {
    disk_max_global<T><<<grid, block, 0, stream>>>(in, out, chords, H, W, r,
                                                   init);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int disk_max_f32(const void* in, void* out, const void* chords,
                            int B, int H, int W, int r, float init,
                            void* stream) {
  return launch(static_cast<const float*>(in), static_cast<float*>(out),
                static_cast<const int*>(chords), B, H, W, r, init,
                static_cast<cudaStream_t>(stream));
}

extern "C" int disk_max_i32(const void* in, void* out, const void* chords,
                            int B, int H, int W, int r, int init,
                            void* stream) {
  return launch(static_cast<const int*>(in), static_cast<int*>(out),
                static_cast<const int*>(chords), B, H, W, r, init,
                static_cast<cudaStream_t>(stream));
}
