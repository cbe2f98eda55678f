// Disk max-filter for greedy non-maximum suppression, for Hopper (sm_90a).
//
// Replaces the TPU kernel _disk_max_kernel / disk_max_pallas
// (topaz_tpu/ops/nms_pallas.py:35-119). For every pixel of a (B, H, W)
// image stack:
//
//     out[b, y, x] = max(init, max over dy^2 + dx^2 <= r^2 of in[b, y + dy, x + dx])
//
// where a tap outside the image reads `init` (-inf for scores, INT32_MIN for
// the index and peak maps of the NMS rounds). The chord half-widths come
// from the host's table, chords[dy + r] = floor(sqrt(r^2 - dy^2)), computed
// as ops/nms._chords_2d does, so no device sqrt can round a chord
// differently.
//
// Work. The disk is the union of its chords. Along one image row the max
// over the chord of half-width w around column c grows incrementally,
// m_w = max(m_{w-1}, row[c - w], row[c + w]), so a pixel costs O(r + r^2 / T)
// steps, not the pi r^2 taps of the disk: about 2r steps of 2 shared-memory
// reads and 2 maxima for its own rows, pi r^2 / (2 T) for the halo rows
// above and below a tile of T rows (16 in the window kernel, 32 in the row
// kernel), which need only short chords, and 2r + 1 folds. At r = 100 and
// T = 16 the halo term (~980) is larger than the row term (~200).
//
// Bound. On paper the function is bytes-bound at r = 14 (8 bytes a pixel at
// 3.35 TB/s against ~60 max operations a pixel at 67 TFLOP/s) and
// operations-bound at r = 100 (~400 chord maxima a pixel). Both kernels are
// held instead by their build steps, 2 shared-memory reads and 2 maxima
// each (~90 reads a pixel at r = 14, ~1,600 shared accesses at r = 100). A
// variant with half the shared reads (two columns a lane) ran slower, so
// instruction issue rather than shared bandwidth looks like the limit; a
// small map adds the latency of one block an SM. PERF.md has the measured
// times beside both bounds.
//
// Two kernels; the launcher picks one for each call from the shared memory
// its block needs, not from r itself:
//
// - disk_max_window, wherever its block fits in shared memory (r <= 85 at
//   widths of 128 or more on an H100 with 227 KB a block). A block stages
//   its whole window (the tile of 16 rows x 32 * warps columns, up to 4
//   warps of columns, and an r-wide halo, `init` outside the image) in
//   shared memory once, column-major with an odd column stride, so a lane
//   that owns one column reads 32 distinct banks. The lane keeps its tile's
//   16 outputs and 16 chord maxima in registers: it walks d = |dy| from r
//   down to 0 and holds the maxima at width chord(d) of the rows t + d, so
//   that each step shifts them by one row, widens the rows it keeps, builds
//   the one it takes in, and folds all 16 into the outputs, at static
//   register indices and static shared offsets, with no barrier. The rows
//   above each tile row take a second warp on the same column (the tile
//   read upside down), which doubles the warps a small map gives; one
//   barrier merges the two. Its window grows as (2r)^2, so it stops where
//   the block no longer fits. It is kept beside the row kernel for the
//   small radii of the picking paths: there the row kernel alone takes
//   1.5-2x its time (r = 14 on (512, 512) and (8, 768, 512)), and the two
//   meet only near r = 85, where a 512-wide block stops fitting
//   (tools/profile_torch_disk_max.py; PERF.md).
// - disk_max_rows, for any r, where the window does not fit. A block owns
//   a tile of kRowTile = 32 rows x 32 pixels and its warps split the tile's
//   32 + 2r window rows, row j to warp j mod warps. A warp stages each row
//   segment (32 + 2 min(r, W - 1) words) with cp.async into a two-row ring
//   while it works on the one before, builds each row's chord maxima once in
//   registers, up to the widest chord any tile row needs from it, and folds
//   them into its own 32 x 32 accumulators in shared memory, which no other
//   lane touches; one barrier merges the warps' accumulators. Shared memory
//   grows linearly in r. The launcher takes fewer than 8 warps where their
//   segments would not fit, and refuses only when one warp's would not
//   either (r above ~11,400 on a map wider than r).
//
// Two caps keep both exact while bounding the work: the host clamps r to
// H + W - 2 (a larger disk covers the same pixels), and widths are capped
// at W - 1 (such a chord already covers the whole row); every output holds
// `init`, so the taps the caps drop change nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 8;
constexpr int kMaxDevices = 64;
constexpr int kWinRows = 16;
constexpr int kRowTile = 32;

// NaN-propagating max, as torch.maximum and jnp.maximum.
__device__ __forceinline__ float take_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ int take_max(int a, int b) { return max(a, b); }

__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row segment [x0 - reach, x0 + 32 + reach) of one image row into `buf`,
// `init` outside the image; one cp.async group a lane.
template <typename T>
__device__ __forceinline__ void stage_row(T* buf, const T* src, int x0,
                                          int reach, int seg, int W, int lane,
                                          T init) {
  for (int i = lane; i < seg; i += kLanes) {
    const int gx = x0 - reach + i;
    if (gx >= 0 && gx < W)
      copy_async(buf + i, src + gx);
    else
      buf[i] = init;
  }
  copy_commit();
}

// One side of the window kernel's sweep for one lane's column. `base` is
// window row r (kDir = +1: the rows t + d below and at each tile row t) or
// window row r + kWinRows - 1 (kDir = -1: the rows t - d above, with the
// tile read upside down, so acc[t] is tile row kWinRows - 1 - t). d = |dy|
// runs from r down to 0; h[t] holds the chord max at width chord[d] of the
// row kDir (d + t) from base. A step shifts h by one row, widens the rows it
// keeps, builds the row it takes in, and folds h into acc, all at static
// register indices and static shared offsets.
template <typename T, int kDir>
__device__ __forceinline__ void sweep(const T* base, const int* chord, int r,
                                      int P, T init, T (&acc)[kWinRows]) {
  T h[kWinRows];
#pragma unroll
  for (int t = 0; t < kWinRows; ++t) {  // d = r: chord(r) = 0
    h[t] = base[kDir * (r + t)];
    acc[t] = take_max(init, h[t]);
  }
  int w = 0;
  for (int d = r - 1; d >= 0; --d) {
    const int wd = chord[d];
#pragma unroll
    for (int t = kWinRows - 1; t > 0; --t) h[t] = h[t - 1];
    const T* row = base + kDir * d;  // h[t] is row[kDir * t]
    for (int k = w + 1; k <= wd; ++k) {
      const T* left = row - k * P;
      const T* right = row + k * P;
#pragma unroll
      for (int t = 1; t < kWinRows; ++t)
        h[t] = take_max(h[t], take_max(left[kDir * t], right[kDir * t]));
    }
    w = wd;
    T m = row[0];
#pragma unroll 4
    for (int k = 1; k <= wd; ++k)
      m = take_max(m, take_max(row[-k * P], row[k * P]));
    h[0] = m;
#pragma unroll
    for (int t = 0; t < kWinRows; ++t) acc[t] = take_max(acc[t], h[t]);
  }
}

// Where its block fits in shared memory: the whole window, column-major, for a
// tile of kWinRows rows x 32 * warps columns. A lane owns one column; the
// block's z = 0 warps sweep the rows below each tile row and the z = 1
// warps the rows above (both take the row itself), and a barrier merges the
// two halves.
template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
disk_max_window(const T* __restrict__ in, T* __restrict__ out,
                const int* __restrict__ chords, int H, int W, int r,
                int reach, T init) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int warps = blockDim.y;
  const int side = threadIdx.z;
  const int tcols = kLanes * warps;  // the tile's columns
  const int ncols = tcols + 2 * reach;
  const int nrows = kWinRows + 2 * r;
  const int P = nrows | 1;  // odd column stride: lanes hit distinct banks
  int* chord = reinterpret_cast<int*>(smem_raw);  // chord[d], d in [0, r]
  T* upper = reinterpret_cast<T*>(smem_raw) + ((r + 4) & ~3);  // kWinRows x tcols
  T* win = upper + kWinRows * tcols;  // win[c * P + i]

  const size_t plane = static_cast<size_t>(H) * W;
  const T* img = in + blockIdx.z * plane;
  const int y0 = blockIdx.y * kWinRows;
  const int x0 = blockIdx.x * tcols;
  const int nthreads = tcols * 2;
  const int tid = (side * warps + warp) * kLanes + lane;
  for (int i = tid; i <= r; i += nthreads) chord[i] = min(chords[r + i], reach);
  // window row i is image row y0 - r + i, window column c image column
  // x0 - reach + c
  for (int i = side * warps + warp; i < nrows; i += 2 * warps) {
    const int gy = y0 - r + i;
    const bool inside = gy >= 0 && gy < H;
    const T* src = img + static_cast<size_t>(inside ? gy : 0) * W;
    for (int c = lane; c < ncols; c += kLanes) {
      const int gx = x0 - reach + c;
      if (inside && gx >= 0 && gx < W)
        copy_async(win + c * P + i, src + gx);
      else
        win[c * P + i] = init;
    }
  }
  copy_commit();
  copy_wait<0>();
  __syncthreads();

  const int tc = warp * kLanes + lane;  // this lane's column in the tile
  const T* col = win + (tc + reach) * P;
  T acc[kWinRows];
  if (side == 0) {
    sweep<T, 1>(col + r, chord, r, P, init, acc);
  } else {
    sweep<T, -1>(col + r + kWinRows - 1, chord, r, P, init, acc);
#pragma unroll
    for (int t = 0; t < kWinRows; ++t)
      upper[(kWinRows - 1 - t) * tcols + tc] = acc[t];
  }
  __syncthreads();
  if (side == 1) return;

  const int gx = x0 + tc;
  if (gx >= W) return;
  T* dst = out + blockIdx.z * plane + gx;
#pragma unroll
  for (int t = 0; t < kWinRows; ++t)
    if (y0 + t < H)
      dst[static_cast<size_t>(y0 + t) * W] =
          take_max(acc[t], upper[t * tcols + tc]);
}

// Any r, run where the window kernel's block does not fit: row segments
// streamed through a two-row ring a warp, chord maxima built once a row and
// folded into accumulators in shared memory, for a tile of kRowTile rows.
template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
disk_max_rows(const T* __restrict__ in, T* __restrict__ out,
              const int* __restrict__ chords, int H, int W, int r, int reach,
              T init) {
  constexpr int rows = kRowTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int warps = blockDim.y;
  const int seg = kLanes + 2 * reach;
  int* chord = reinterpret_cast<int*>(smem_raw);  // chord[d], d in [0, r]
  T* smem = reinterpret_cast<T*>(smem_raw) + ((r + 4) & ~3);
  T* acc = smem + warp * rows * kLanes + lane;  // acc[t * kLanes], t < rows
  T* ring = smem + warps * rows * kLanes + warp * 2 * seg;

  const size_t plane = static_cast<size_t>(H) * W;
  const T* img = in + blockIdx.z * plane;
  const int y0 = blockIdx.y * rows;
  const int x0 = blockIdx.x * kLanes;
  for (int i = warp * kLanes + lane; i <= r; i += warps * kLanes)
    chord[i] = min(chords[r + i], reach);
  for (int t = 0; t < rows; ++t) acc[t * kLanes] = init;
  __syncthreads();

  // window rows j (image row y0 + j) inside the image and within r of the
  // tile; rows outside the image only add `init`, which every output holds
  const int jlo = max(-r, -y0);
  const int jhi = min(rows + r, H - y0);
  int j = jlo + warp;
  if (j < jhi)
    stage_row(ring, img + static_cast<size_t>(y0 + j) * W, x0, reach, seg, W,
              lane, init);
  for (int n = 0; j < jhi; j += warps, ++n) {
    const int next = j + warps;
    if (next < jhi) {
      stage_row(ring + ((n + 1) & 1) * seg,
                img + static_cast<size_t>(y0 + next) * W, x0, reach, seg, W,
                lane, init);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncwarp();

    // Output row t sees row j at dy = j - t, through the chord of d = |dy|:
    // t = j - d for d <= j and t = j + d for 0 < d < rows - j. d runs from
    // dmax down to dmin, so the widths it needs only grow and one pass of
    // the build serves them all: first the d that reach one side of the
    // tile only, then those that reach both, then d = 0.
    const T* row = ring + (n & 1) * seg + reach + lane;
    const int below = j;             // t = j - d lies in the tile for d <= below
    const int above = rows - 1 - j;  // t = j + d for d <= above
    const int dmin = j < 0 ? -j : (j >= rows ? j - rows + 1 : 0);
    const int dmax = min(r, max(below, above));
    const int both = min(min(below, above), dmax);
    T m = row[0];
    int w = 0;
    int d = dmax;
    {
      const int step = below > above ? kLanes : -kLanes;
      T* p = acc + (below > above ? j - d : j + d) * kLanes;
      for (; d > both && d >= dmin; --d, p += step) {
        const int wd = chord[d];
#pragma unroll 4
        for (; w < wd; ++w) m = take_max(m, take_max(row[-w - 1], row[w + 1]));
        *p = take_max(*p, m);
      }
    }
    T* p1 = acc + (j - d) * kLanes;
    T* p2 = acc + (j + d) * kLanes;
    for (; d >= 1 && d >= dmin; --d, p1 += kLanes, p2 -= kLanes) {
      const int wd = chord[d];
#pragma unroll 4
      for (; w < wd; ++w) m = take_max(m, take_max(row[-w - 1], row[w + 1]));
      *p1 = take_max(*p1, m);
      *p2 = take_max(*p2, m);
    }
    if (d == 0 && dmin == 0) {
      for (; w < chord[0]; ++w) m = take_max(m, take_max(row[-w - 1], row[w + 1]));
      *p1 = take_max(*p1, m);
    }
    __syncwarp();  // every lane has read this buffer before it is restaged
  }
  __syncthreads();

  const int gx = x0 + lane;
  T* dst = out + blockIdx.z * plane;
  for (int t = warp; t < rows && y0 + t < H; t += warps) {
    T v = smem[t * kLanes + lane];
    for (int q = 1; q < warps; ++q)
      v = take_max(v, smem[(q * rows + t) * kLanes + lane]);
    if (gx < W) dst[static_cast<size_t>(y0 + t) * W + gx] = v;
  }
}

// Shared memory of a window-kernel block: the chord table, the upper half's
// outputs and the window.
template <typename T>
size_t window_bytes(int r, size_t reach, int warps) {
  const size_t tcols = kLanes * static_cast<size_t>(warps);
  const size_t P = (kWinRows + 2 * static_cast<size_t>(r)) | 1;
  return ((r + 4) & ~3) * sizeof(int) +
         (kWinRows * tcols + (tcols + 2 * reach) * P) * sizeof(T);
}

// The window kernel wherever its block fits in shared memory, with 4 column
// groups, or fewer where more than a quarter of the lanes would sit past the
// image's right edge; elsewhere the row kernel, with 8 warps, or fewer where
// their row segments would not fit.
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
  const size_t limit = static_cast<size_t>(max_optin);

  const size_t reach = r < W - 1 ? r : W - 1;
  int warps = kMaxWarps / 2;
  while (warps > 1) {
    const int cover = (W + kLanes * warps - 1) / (kLanes * warps) * kLanes * warps;
    if (4 * (cover - W) <= cover) break;
    warps /= 2;
  }
  const bool window = window_bytes<T>(r, reach, warps) <= limit;
  size_t shared;
  dim3 grid;
  if (window) {
    shared = window_bytes<T>(r, reach, warps);
    grid = dim3((W + kLanes * warps - 1) / (kLanes * warps),
                (H + kWinRows - 1) / kWinRows, B);
  } else {
    // each warp holds its own accumulators and two row segments
    const size_t per_warp =
        (static_cast<size_t>(kRowTile) * kLanes + 2 * (kLanes + 2 * reach)) * sizeof(T);
    const size_t table = ((r + 4) & ~3) * sizeof(int);
    warps = kMaxWarps;
    while (warps > 1 && table + warps * per_warp > limit) --warps;
    shared = table + warps * per_warp;
    grid = dim3((W + kLanes - 1) / kLanes, (H + kRowTile - 1) / kRowTile, B);
  }
  if (shared > limit || grid.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  // allow the opt-in maximum once a device; a launch takes what it asks for
  static bool opted_in[kMaxDevices] = {};
  if (device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(disk_max_window<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(disk_max_rows<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) opted_in[device] = true;
  }
  if (window)
    disk_max_window<T><<<grid, dim3(kLanes, warps, 2), shared, stream>>>(
        in, out, chords, H, W, r, static_cast<int>(reach), init);
  else
    disk_max_rows<T><<<grid, dim3(kLanes, warps), shared, stream>>>(
        in, out, chords, H, W, r, static_cast<int>(reach), init);
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
