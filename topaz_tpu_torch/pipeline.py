"""Batched micrograph pipeline (port of topaz_tpu/pipeline.py, one device):
mixed-size micrograph sets -> [downsample ->] masked GMM normalization ->
dense scoring -> greedy NMS [-> denoise], B micrographs at a time.

Micrographs are grouped into rounded shape buckets: each image is
zero-padded up to the next ``bucket_step`` multiple, so near-miss camera
geometries batch together. Padding is masked out everywhere it could change
a result:

  * the GMM fits only valid pixels (weighted sufficient statistics and the
    masked quantile init, ops/gmm.py; the reference's stats never see
    padding, topaz/stats.py:36-83);
  * the normalized image is re-zeroed outside the valid region, so dense
    scoring sees exactly the zero padding the picker applies at a true
    image edge;
  * NMS candidates outside the valid region are -inf
    (topaz/algorithms.py:25-63 only ever sees real pixels).

Fourier-crop downsampling cannot run on a padded image (the FFT is global),
so for ``scale > 1`` each image is downsampled on its own (on the device, or
in the loader threads with ``host_downsample``) and then embedded in its
bucket. The score map of a batch stays on the device for the NMS rounds,
whose disk max-filter is the CUDA kernel of ops/disk_max.py at (B, bh, bw);
only the pick tables (and the denoised images) come back, with one
synchronisation a batch. Loader threads read files (and run the host FFT)
while the device works.
"""

from __future__ import annotations

import os
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.io.image import load_image
from topaz_tpu_torch.io.mrc import parse_header
from topaz_tpu_torch.models.denoise_factory import load_denoiser
from topaz_tpu_torch.models.factory import load_picker
from topaz_tpu_torch.ops.fourier import downsample, downsample_numpy
from topaz_tpu_torch.ops.gmm import norm_fit, norm_fit_hist
from topaz_tpu_torch.ops.nms import NEG, nms_topk_batched
from topaz_tpu_torch.utils.batching import (fetch_async, iterate_prefetched, load_batches,
                                             round_bucket, valid_mask)
from topaz_tpu_torch.utils.profiling import stage, sync_for_timing
from topaz_tpu_torch.utils.retry import retry_transient

# the port runs float32 convolutions with TF32 off only (device.exact_numerics)
_F32_PRECISIONS = (None, "highest", "float32", "f32")


class MicrographPipeline:
    """preprocess (downsample + GMM normalize) -> score -> NMS [-> denoise]
    for batches of micrographs on one device."""

    def __init__(
        self,
        model: str = "resnet8_u32",
        denoise_model: Optional[str] = None,
        scale: int = 8,
        radius: int = 14,
        threshold: float = -6.0,
        max_peaks: Optional[int] = None,
        normalize: bool = True,
        mesh=None,
        precision=None,
        bucket_step: int = 64,
        host_downsample: bool = False,
        num_workers: int = 4,
        bins: int = 0,
        dtype=None,
        skip_errors: bool = False,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "MicrographPipeline over a device mesh is not yet ported to "
                "topaz_tpu_torch (ROADMAP P14)")
        if precision not in _F32_PRECISIONS:
            raise ValueError(
                f"precision {precision!r}: the port scores in float32 with TF32 "
                f"off only; use dtype='bf16' for the fast denoise arm")
        if dtype not in (None, "f32", "bf16", "bfloat16"):
            raise ValueError(f"unsupported dtype {dtype!r}: use f32 or bf16")
        self.device = resolve_device(device)
        self.scale = scale
        self.normalize = normalize
        self.radius = radius
        self.threshold = threshold
        self.max_peaks = max_peaks
        self.bucket_step = max(1, int(bucket_step))
        # host_downsample: the Fourier crop runs in the loader threads
        # (scipy's pocketfft), so only scale^2-fewer pixels are uploaded
        self.host_downsample = host_downsample
        self.num_workers = max(1, int(num_workers))
        # bins > 0: histogram-EM normalization over valid pixels
        self.bins = int(bins)
        # skip_errors: warn and go on past unreadable or corrupt files
        # instead of failing the run (the reference fails on the first)
        self.skip_errors = bool(skip_errors)
        # transient device failures are retried once; program errors, OOM
        # and sticky CUDA errors never (utils/retry.py)
        self.retries = 1
        self.picker = load_picker(model, device=self.device)
        # dtype='bf16': the denoise arm in bfloat16 with float32 out;
        # scoring and NMS stay float32 so picks keep their parity
        self.denoiser = None
        if denoise_model is not None:
            self.denoiser = load_denoiser(denoise_model, device=self.device)
            if dtype in ("bf16", "bfloat16"):
                self.denoiser = self.denoiser.to(torch.bfloat16)
        self._fns: Dict = {}       # bucket -> main batch function
        self._prep_fns: Dict = {}  # (raw shape, bucket) -> downsample + embed

    @property
    def num_programs(self) -> Dict[str, int]:
        """Census of the JAX package's compiled programs, counted the same
        way: 'main' = one per bucket, 'prep' = one per raw geometry whose
        downsample runs on the device."""
        return {"main": len(self._fns), "prep": len(self._prep_fns)}

    # -- shape bucketing ----------------------------------------------------

    def _ds_shape(self, raw_shape: Tuple[int, int]) -> Tuple[int, int]:
        """Shape after Fourier-crop downsampling (ops/fourier.py)."""
        if self.scale > 1:
            return (int(raw_shape[0] / self.scale),
                    int(raw_shape[1] / self.scale))
        return tuple(raw_shape)

    def _bucket_for(self, ds_shape: Tuple[int, int]) -> Tuple[int, int]:
        return round_bucket(ds_shape, self.bucket_step)

    # -- per-bucket batch functions -----------------------------------------

    def _build(self, bucket: Tuple[int, int]):
        bh, bw = bucket
        r, t = self.radius, self.threshold
        # top-k bound: peaks are pairwise > r apart, so a packing bound on
        # the bucket-shaped score map never truncates
        if self.max_peaks is not None:
            k = min(self.max_peaks, bh * bw)
        else:
            k = min(bh * bw,
                    int((bh + r) * (bw + r) / max(np.pi * (r / 2.0) ** 2, 1)) + 16)
        picker, denoiser = self.picker, self.denoiser
        normalize, bins = self.normalize, self.bins

        @torch.inference_mode()
        def fn(padded: torch.Tensor, valid: torch.Tensor):
            # padded (B, bh, bw) after downsampling, valid (B, 2)
            B = padded.shape[0]
            mask = valid_mask((bh, bw), valid)
            maskf = mask.to(padded.dtype)
            # dead-frame guard (a documented divergence: the reference's
            # unguarded std division NaNs the frame, topaz/stats.py:36-83):
            # a constant frame gives 0 picks and passes through the denoise
            # arm unchanged, and the flag goes back for a warning
            nv = torch.sum(maskf, dim=(1, 2), keepdim=True)
            m2 = torch.sum(padded * maskf, dim=(1, 2), keepdim=True) / nv
            v2 = torch.sum(maskf * (padded - m2) ** 2, dim=(1, 2), keepdim=True) / nv
            degen = (v2 <= 0.0)[:, 0, 0]
            if normalize:
                xf, wf = padded.reshape(B, -1), maskf.reshape(B, -1)
                if bins > 0:
                    mu, std, *_ = norm_fit_hist(xf, bins=bins, w=wf)
                else:
                    mu, std, *_ = norm_fit(xf, w=wf)
                # re-zero the padding so the picker sees a true image edge
                norms = (padded - mu[:, None, None]) / std[:, None, None] * maskf
            else:
                # extract's inputs are already normalized; padding is zero
                norms = padded
            scores = picker(norms)
            neg = torch.tensor(NEG, dtype=scores.dtype, device=scores.device)
            scores = torch.where(mask & ~degen[:, None, None], scores, neg)
            vals, coords, counts = nms_topk_batched(scores, r, t, k)
            out = (vals, coords, counts, degen)
            if denoiser is not None:
                # per-image masked statistics (the reference's _denoise,
                # topaz/denoise.py:274-296) of the zero-padded bucket, as
                # the JAX package runs it; s2 is guarded so that a dead
                # frame passes through
                s2 = torch.where(degen[:, None, None], torch.ones_like(v2), torch.sqrt(v2))
                norm_in = ((padded - m2) / s2) * maskf
                wdtype = next(denoiser.parameters()).dtype
                # small buckets run the U-Net batched; large micrographs one
                # at a time, so decoder temporaries are not B-fold
                if B * bh * bw <= 8 * 1024 * 1024:
                    y = denoiser(norm_in[:, None].to(wdtype))[:, 0].float()
                else:
                    y = torch.stack([denoiser(xi[None, None].to(wdtype))[0, 0].float()
                                     for xi in norm_in])
                den = y * s2 + m2
                den = torch.where(degen[:, None, None], padded, den)
                out = out + (den,)
            return out

        return fn

    def _fn_for(self, bucket: Tuple[int, int]):
        if bucket not in self._fns:
            self._fns[bucket] = self._build(bucket)
        return self._fns[bucket]

    def _prep_for(self, raw_shape: Tuple[int, int], bucket: Tuple[int, int]):
        """Per-geometry device prep: Fourier-crop downsample, then embed in
        the zero-filled bucket. The FFT must see the unpadded image."""
        key = (tuple(raw_shape), bucket)
        if key not in self._prep_fns:
            scale, ds = self.scale, self._ds_shape(raw_shape)

            def prep(raw: torch.Tensor) -> torch.Tensor:
                small = downsample(raw, scale, shape=ds, device=raw.device)
                out = torch.zeros(bucket, dtype=torch.float32, device=raw.device)
                out[: ds[0], : ds[1]] = small
                return out

            self._prep_fns[key] = prep
        return self._prep_fns[key]

    # -- host-side driver ---------------------------------------------------

    def _load_one(self, path: str, bucket: Tuple[int, int]):
        """Read one micrograph in a loader thread (host I/O and scipy only,
        no CUDA): the raw image when the device downsamples it, else the
        [downsampled] image embedded in its bucket."""
        raw = np.asarray(load_image(path), dtype=np.float32)
        if raw.ndim != 2:
            # stacks, volumes, RGB: the shape probe reads only (ny, nx), so
            # the embed and mask would silently be wrong
            raise ValueError(
                f"{path}: the batched micrograph pipeline handles single "
                f"2D images (got shape {raw.shape}); denoise --stack "
                f"handles movie stacks")
        if self.scale > 1 and not self.host_downsample:
            return np.array(raw)  # writable: torch.from_numpy takes it next
        if self.scale > 1:
            small = downsample_numpy(raw, self.scale, shape=self._ds_shape(raw.shape))
        else:
            small = raw
        out = np.zeros(bucket, np.float32)
        out[: small.shape[0], : small.shape[1]] = small
        return out

    def process(self, paths: Sequence[str], batch_size: Optional[int] = None,
                prefetch: int = 2):
        """Process micrograph files; yields (path, pick scores, pick coords
        (x, y) at the downsampled scale[, denoised image cropped to its true
        size]), bucket by bucket, in input order within a bucket. The last
        partial batch of a bucket is padded by repetition (those results are
        dropped). ``num_workers`` loader threads overlap file reads (and
        host FFTs) with the device's work."""
        batch_size = 1 if batch_size is None else max(1, int(batch_size))

        # bucket by rounded post-downsample shape, keeping order within
        buckets: Dict[Tuple[int, int], List[Tuple[str, Tuple[int, int]]]] = \
            defaultdict(list)
        for p in paths:
            try:
                raw_shape = _image_shape(p)
            except Exception:
                if not self.skip_errors:
                    raise
                warnings.warn(f"{p}: unreadable header — skipped (--skip-errors)")
                continue
            buckets[self._bucket_for(self._ds_shape(raw_shape))].append((p, raw_shape))

        def produce():
            for bucket, items in buckets.items():
                for chunk, loaded in load_batches(
                        items, lambda it, b=bucket: self._load_one(it[0], b),
                        batch_size, batch_size * (prefetch + 1),
                        num_workers=self.num_workers, skip_errors=self.skip_errors,
                        label=lambda it: it[0]):
                    n_real = len(chunk)
                    valid = np.array(
                        [self._ds_shape(rs) for _, rs in chunk]
                        + [self._ds_shape(chunk[-1][1])] * (batch_size - n_real),
                        dtype=np.int64)
                    if self.scale > 1 and not self.host_downsample:
                        payload = loaded  # raw images; the device downsamples
                    else:
                        payload = np.stack(loaded)
                    yield bucket, chunk, payload, valid

        device = self.device
        for bucket, chunk, payload, valid in iterate_prefetched(
                produce, maxsize=max(1, prefetch)):
            fn = self._fn_for(bucket)

            def dispatch_and_fetch():
                with stage(f"pipeline/batch{bucket}"):
                    if isinstance(payload, list):
                        arr = torch.stack([
                            self._prep_for(r.shape, bucket)(torch.from_numpy(r).to(device))
                            for r in payload])
                    else:
                        arr = torch.from_numpy(payload).to(device)
                    out = fn(arr, torch.from_numpy(valid).to(device))
                    # the stage's time includes the device's when timings
                    # or a profile are asked for
                    sync_for_timing(out)
                # the copy-out is inside the retried call: a dropped
                # transport can surface there
                return fetch_async(*out[:4], out[4] if len(out) > 4 else None)

            scores, coords, counts, degen, dens = retry_transient(
                dispatch_and_fetch, retries=self.retries,
                what=f"pipeline batch {bucket}")
            for i, (path, _raw_shape) in enumerate(chunk):
                if degen[i]:
                    warnings.warn(
                        f"{path}: constant image (std=0) — no picks emitted and "
                        f"denoising passes it through unchanged (the reference "
                        f"NaNs such frames)")
                n = int(counts[i])
                result = (path, scores[i, :n], coords[i, :n])
                if dens is not None:
                    vh, vw = valid[i]
                    result = result + (dens[i, :vh, :vw],)
                yield result


def _image_shape(path: str) -> Tuple[int, int]:
    """Cheap (H, W) probe per format: the header for MRC, metadata for PIL
    formats, a memory map for npy."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".mrc", ".mrcs"):
        with open(path, "rb") as f:
            h = parse_header(f.read(1024))
        return (int(h.ny), int(h.nx))
    if ext in (".tiff", ".tif", ".png", ".jpg", ".jpeg"):
        from PIL import Image

        with Image.open(path) as im:
            return (im.height, im.width)
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r")
        return (arr.shape[-2], arr.shape[-1])
    raise ValueError(f"unsupported micrograph format for batching: {path}")
