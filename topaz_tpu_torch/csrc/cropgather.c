/* Batched crop gathering from memory-mapped micrographs, on the host: the
 * port's own copy of topaz_tpu/native/cropgather.c (gather_crops,
 * gather_rotated_crops), built by topaz_tpu_torch/_build.py into the
 * package's _build/ directory and loaded with ctypes by
 * topaz_tpu_torch/train/cropgather.py.
 *
 * The training sampler pulls hundreds of random windows a step from
 * mmapped MRC pixel arrays (the reference's per-item Python Dataset,
 * topaz/utils/data/memory_mapped_data.py:45-70). One C call gathers the
 * crops of one image, so no Python loop runs per pixel or per row.
 *
 * dtype codes: 0 = float32, 1 = int16, 2 = int8, 3 = uint16, 4 = float64.
 */

#include <stdint.h>
#include <string.h>

typedef float f32;

static inline f32 load_px(const void *img, int dtype, int64_t idx) {
    switch (dtype) {
        case 0: return ((const float *)img)[idx];
        case 1: return (f32)((const int16_t *)img)[idx];
        case 2: return (f32)((const int8_t *)img)[idx];
        case 3: return (f32)((const uint16_t *)img)[idx];
        case 4: return (f32)((const double *)img)[idx];
        default: return 0.0f;
    }
}

/* Gather n crops of (size x size) windows with top-left corners
 * (ys[i], xs[i]) from one (H x W) image; out is (n, size, size) float32,
 * out-of-bounds regions zeroed. */
void gather_crops(const void *img, int dtype, int64_t H, int64_t W,
                  const int64_t *ys, const int64_t *xs, int64_t n,
                  int64_t size, f32 *out) {
    for (int64_t i = 0; i < n; i++) {
        f32 *dst = out + i * size * size;
        memset(dst, 0, sizeof(f32) * size * size);
        int64_t y0 = ys[i];
        int64_t x0 = xs[i];
        int64_t ry0 = y0 < 0 ? 0 : y0;
        int64_t ry1 = (y0 + size) > H ? H : (y0 + size);
        int64_t rx0 = x0 < 0 ? 0 : x0;
        int64_t rx1 = (x0 + size) > W ? W : (x0 + size);
        if (ry0 >= ry1 || rx0 >= rx1) continue;
        int64_t ncols = rx1 - rx0;
        for (int64_t y = ry0; y < ry1; y++) {
            f32 *drow = dst + (y - y0) * size + (rx0 - x0);
            if (dtype == 0) {
                memcpy(drow, (const float *)img + y * W + rx0,
                       sizeof(f32) * (size_t)ncols);
            } else {
                const int64_t base = y * W + rx0;
                for (int64_t c = 0; c < ncols; c++) {
                    drow[c] = load_px(img, dtype, base + c);
                }
            }
        }
    }
}

/* Fused augmented gather: for each crop, sample a (size x size) window
 * centered at (cys[i], cxs[i]) rotated by angles[i] radians
 * (counter-clockwise, nearest neighbor) with optional horizontal/vertical
 * output flips; out-of-image sources are zero. Replaces the reference's
 * oversized-crop -> rotate -> center-crop -> flip chain
 * (memory_mapped_data.py:216-231) with one pass at load time. */
void gather_rotated_crops(const void *img, int dtype, int64_t H, int64_t W,
                          const int64_t *cys, const int64_t *cxs,
                          const double *angles, const uint8_t *hflip,
                          const uint8_t *vflip, int64_t n, int64_t size,
                          f32 *out) {
    double half = (double)(size - 1) / 2.0;
    for (int64_t i = 0; i < n; i++) {
        f32 *dst = out + i * size * size;
        double cy = (double)cys[i];
        double cx = (double)cxs[i];
        /* output = flip(rotate(input)); source coord = R(-theta) * F(out) */
        double c = __builtin_cos(angles[i]);
        double s = __builtin_sin(angles[i]);
        int hf = hflip[i], vf = vflip[i];
        for (int64_t r = 0; r < size; r++) {
            double v0 = (double)r - half;
            double v = vf ? -v0 : v0;
            for (int64_t col = 0; col < size; col++) {
                double u0 = (double)col - half;
                double u = hf ? -u0 : u0;
                /* inverse rotation (image rotated CCW by theta) */
                double sy = c * v + s * u + cy;
                double sx = -s * v + c * u + cx;
                int64_t iy = (int64_t)(sy + (sy >= 0 ? 0.5 : -0.5));
                int64_t ix = (int64_t)(sx + (sx >= 0 ? 0.5 : -0.5));
                dst[r * size + col] =
                    (iy >= 0 && iy < H && ix >= 0 && ix < W)
                        ? load_px(img, dtype, iy * W + ix)
                        : 0.0f;
            }
        }
    }
}
