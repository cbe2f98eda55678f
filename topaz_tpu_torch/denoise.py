"""Denoising workflow for 2D micrographs (port of the 2D inference part of
topaz_tpu/denoise.py, the reference's topaz/denoise.py:245-490 and
topaz/commands/denoise.py).

Each micrograph is uploaded once; the filter pipeline (lowpass ->
normalize and pixel cutoff -> gaussian, inverse gaussian or whitening
deconvolution -> model average -> rescale) and the model run on the
device, and the denoised image is copied back once. Whole-image denoising
normalizes by the image's own statistics. Patch denoising cuts every patch
from the resident micrograph, normalizes each by its own statistics, as
the reference does (topaz/denoise.py:299-324), and writes its centre into
a device output. Standard deviations are population ones (ddof 0), as in
numpy and JAX.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np
import torch

from topaz_tpu_torch.device import as_device_tensor, resolve_device
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.io.image import load_image, save_image
from topaz_tpu_torch.models.denoise import min_input_size
from topaz_tpu_torch.models.denoise_factory import denoiser_from_numpy, load_denoiser
from topaz_tpu_torch.ops import fourier
from topaz_tpu_torch.ops.filters import (
    apply_kernel,
    correct_spatial_covariance,
    gaussian_denoise_kernel,
    inv_gaussian_kernel,
)


def _check_min_extent(meta, extents, what: str, flag: str):
    """Clear error when an input is smaller than the arch's pooling
    pyramid allows, instead of an empty-axis failure inside the model."""
    min_in = min_input_size(meta["arch"])
    if any(int(s) < min_in for s in extents):
        raise ValueError(
            f"{what} of size {tuple(int(s) for s in extents)} are smaller "
            f"than the {meta['arch']!r} denoiser's minimum input of "
            f"{min_in} per dimension (its pooling levels would collapse "
            f"an axis); raise {flag}")


def _std(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Population standard deviation (numpy's and JAX's default)."""
    return torch.std(x, dim=dim, keepdim=keepdim, correction=0)


class Denoise:
    """2D micrograph denoiser (topaz/denoise.py:245-332): one model on one
    device. ``dtype="bf16"`` runs weights and activations in bfloat16 with
    float32 statistics and output. Methods take arrays or tensors and
    return float32 tensors on ``self.device``."""

    def __init__(self, model: str = "unet", device="cuda", *, meta=None,
                 params=None, dtype=None):
        if dtype not in (None, "f32", "bf16"):
            raise ValueError(f"unsupported denoise dtype {dtype!r}: use f32 or bf16")
        self.device = resolve_device(device)
        if meta is not None:
            net = denoiser_from_numpy(meta, params)
        else:
            net = load_denoiser(model, device=self.device)
        self.meta = net.meta
        self.dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
        self.model = net.to(device=self.device, dtype=self.dtype)
        # smallest whole-image pixel count that ran out of device memory in
        # this instance; images this large go straight to patches
        self._oom_area = None

    def _normalized_forward(self, xb: torch.Tensor) -> torch.Tensor:
        """(B, H, W) frames, each normalized by its own mean and std,
        denoised, and restored to its own scale."""
        mu = xb.mean(dim=(1, 2), keepdim=True)
        std = _std(xb, dim=(1, 2), keepdim=True)
        with torch.inference_mode():
            y = self.model(((xb - mu) / std)[:, None].to(self.dtype))[:, 0]
        return y.float() * std + mu

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        """Denoise one whole image with its own statistics
        (topaz/denoise.py:274-296). A device out-of-memory falls back to
        patch denoising with a warning, on the same device."""
        if self._oom_area is not None and x.numel() >= self._oom_area:
            return self._patch_fallback(x)
        try:
            return self._normalized_forward(x[None])[0]
        except torch.cuda.OutOfMemoryError as e:
            # drop the traceback: its frames hold the failed forward's tensors
            err = e.with_traceback(None)
        self._oom_area = x.numel() if self._oom_area is None else min(self._oom_area, x.numel())
        if x.is_cuda:
            torch.cuda.empty_cache()
        return self._patch_fallback(x, err=err)

    def _patch_fallback(self, x: torch.Tensor, err=None) -> torch.Tensor:
        """Patch-denoise an image too large for whole-image device memory,
        at the reference defaults (-s 1024 -p 500) shrunk until a padded
        patch is well under the area that failed, so that no patch can
        re-enter this fallback at the same size."""
        patch, padding = 1024, 500
        while ((patch + 2 * padding) ** 2 > self._oom_area // 2 and patch > 64):
            patch //= 2
            padding = min(padding, patch // 2)
        if (patch + 2 * padding) ** 2 > self._oom_area // 2:
            if err is not None:
                raise err
            raise RuntimeError(
                f"denoising {tuple(x.shape)} ran out of device memory and even "
                f"{patch}px patches exceed the failing footprint; use a device "
                f"with more memory or --precision bf16")
        print(f"# WARNING: whole-image denoising of {tuple(x.shape)} exceeds "
              f"device memory; falling back to -s {patch} -p {padding} "
              f"patches (per-patch statistics). --precision bf16 halves "
              f"activation memory.", file=sys.stderr)
        return self.denoise_patches(x, patch, padding=padding)

    def denoise_patches(self, x, patch_size: int, padding: int = 128) -> torch.Tensor:
        """Patch-tiled denoising with per-patch statistics
        (topaz/denoise.py:299-324): every ``patch_size`` tile is denoised in
        a window padded by ``padding`` (cut short at the image edge) and its
        centre kept. The image stays on the device throughout."""
        x = as_device_tensor(x, self.device)
        H, W = x.shape
        s, p = int(patch_size), int(padding)
        y = torch.empty_like(x)
        for i in range(0, H, s):
            for j in range(0, W, s):
                si, ei = max(0, i - p), min(H, i + s + p)
                sj, ej = max(0, j - p), min(W, j + s + p)
                yij = self._apply(x[si:ei, sj:ej])
                y[i:i + s, j:j + s] = yij[i - si:i - si + s, j - sj:j - sj + s]
        return y

    def denoise(self, x, patch_size: int = -1, padding: int = 128) -> torch.Tensor:
        """Denoise one 2D image, whole or (``patch_size > 0`` and the
        image larger than a patch plus its padding) in patches."""
        x = as_device_tensor(x, self.device)
        if x.ndim != 2:
            raise ValueError(f"expected a 2D micrograph, got shape {tuple(x.shape)}; "
                             f"denoise a stack of frames with --stack")
        s = patch_size + padding
        use_patch = patch_size > 0 and (s < x.shape[0] or s < x.shape[1])
        if use_patch:
            _check_min_extent(self.meta, (patch_size + 2 * padding,) * 2,
                              "inference patches", "-s/--patch-size")
            return self.denoise_patches(x, patch_size, padding=padding)
        _check_min_extent(self.meta, x.shape, "images",
                          "the input size or pick a shallower arch (unet-small)")
        return self._apply(x)

    def denoise_batch(self, frames) -> torch.Tensor:
        """Denoise a (B, H, W) batch of same-shape frames in one forward,
        each with its own statistics. A device out-of-memory degrades to
        one frame at a time, with a warning."""
        frames = as_device_tensor(frames, self.device)
        _check_min_extent(self.meta, frames.shape[1:], "frames",
                          "the frame size or pick a shallower arch (unet-small)")
        try:
            return self._normalized_forward(frames)
        except torch.cuda.OutOfMemoryError:
            pass
        if frames.is_cuda:
            torch.cuda.empty_cache()
        print(f"# WARNING: batched denoising of {tuple(frames.shape)} exceeds "
              f"device memory; denoising frames one at a time", file=sys.stderr)
        return torch.stack([self._apply(f) for f in frames])


# ---------------------------------------------------------------------------
# 2D pipeline drivers (topaz/denoise.py:382-490)
# ---------------------------------------------------------------------------

def denoise_image(mic, models: List[Denoise], lowpass: float = 1,
                  cutoff: float = 0, gaus: Optional[float] = None,
                  inv_gaus: Optional[float] = None, deconvolve: bool = False,
                  deconv_patch: int = 1, patch_size: int = -1,
                  padding: int = 0, normalize: bool = False,
                  downsample: int = 1) -> np.ndarray:
    """Full single-micrograph pipeline (topaz/denoise.py:382-416) on the
    models' device. ``downsample > 1`` Fourier-crops the micrograph first
    and denoises at the reduced scale; the output is then downsampled."""
    device = models[0].device
    x = as_device_tensor(mic, device)
    if downsample > 1:
        x = fourier.downsample(x, downsample, device=device)
    if lowpass > 1:
        x = fourier.lowpass(x, lowpass, device=device)

    mu, std = x.mean(), _std(x)
    x = (x - mu) / std
    if cutoff > 0:
        x = torch.where((x < -cutoff) | (x > cutoff), 0.0, x)

    if gaus is not None:
        x = apply_kernel(x, gaussian_denoise_kernel(gaus), device=device)
    elif inv_gaus is not None:
        x = apply_kernel(x, inv_gaussian_kernel(inv_gaus), device=device)
    elif deconvolve:
        x = correct_spatial_covariance(x, patch=deconv_patch, device=device)

    out = sum(model.denoise(x, patch_size=patch_size, padding=padding)
              for model in models) / len(models)

    if normalize:
        out = (out - out.mean()) / _std(out)
    else:
        out = std * out + mu
    return out.cpu().numpy()


def denoise_stream(micrographs: List[str], output_path: str, format: str = "mrc",
                   suffix: str = "", models: Optional[List[Denoise]] = None,
                   lowpass: float = 1, pixel_cutoff: float = 0,
                   gaus=None, inv_gaus=None, deconvolve: bool = False,
                   deconv_patch: int = 1, patch_size: int = 1024,
                   padding: int = 500, normalize: bool = False,
                   downsample: int = 1):
    """Per-micrograph denoise and save (topaz/denoise.py:450-490). The next
    micrograph loads in a prefetch thread and the previous one saves in a
    writer thread while the device works; a failed save raises on the next
    iteration or at the end. Outputs are written, not kept: a session's
    thousands of micrographs would not fit in host memory."""
    import concurrent.futures as cf

    from topaz_tpu_torch.utils.batching import iterate_prefetched

    total, count = len(micrographs), 0
    if output_path:
        os.makedirs(output_path, exist_ok=True)

    def produce():
        for path in micrographs:
            name = os.path.splitext(os.path.basename(path))[0]
            image, header, ext_header = load_image(path, return_header=True)
            yield path, name, image, header, ext_header

    writer = cf.ThreadPoolExecutor(max_workers=1)
    pending: List = []

    def surface_save_errors(block: bool = False):
        for f in list(pending):
            if block or f.done():
                f.result()  # re-raises a failed save
                pending.remove(f)

    try:
        for path, name, image, header, ext_header in iterate_prefetched(produce, maxsize=2):
            out = denoise_image(image, models, lowpass=lowpass,
                                cutoff=pixel_cutoff, gaus=gaus,
                                inv_gaus=inv_gaus, deconvolve=deconvolve,
                                deconv_patch=deconv_patch,
                                patch_size=patch_size, padding=padding,
                                normalize=normalize, downsample=downsample)
            if not output_path:
                outpath = os.path.splitext(path)[0] + (suffix or ".denoised") + "." + format
            else:
                outpath = os.path.join(output_path, name + suffix + "." + format)
            surface_save_errors()
            pending.append(writer.submit(save_image, out, outpath, header=header,
                                         extended_header=ext_header))
            count += 1
            print(f"# {count} of {total} completed.", file=sys.stderr, end="\r")
        surface_save_errors(block=True)
    finally:
        writer.shutdown(wait=True)
    print("", file=sys.stderr)


def denoise_stack(path: str, output_path: str, models: List[Denoise],
                  lowpass: float = 1, pixel_cutoff: float = 0, gaus=None,
                  inv_gaus=None, deconvolve: bool = False, deconv_patch: int = 1,
                  patch_size: int = 1024, padding: int = 500,
                  normalize: bool = False, downsample: int = 1):
    """Denoise every frame of one MRC stack (topaz/denoise.py:419-447).
    When the per-frame pipeline is only normalize -> model -> restore (no
    filter, no patches, one model), frames go through the model eight at a
    time."""
    stack, header, ext_header = mrc.read(path)
    print("# denoising stack with shape:", stack.shape, file=sys.stderr)

    H, W = stack.shape[-2:]
    s = patch_size + padding
    use_patch = patch_size > 0 and (s < H or s < W)
    trivial_filters = (lowpass <= 1 and pixel_cutoff <= 0 and gaus is None
                       and inv_gaus is None and not deconvolve and downsample == 1)
    if trivial_filters and not use_patch and len(models) == 1 and len(stack) > 1:
        denoised = np.zeros(stack.shape, dtype=np.float32)
        for start in range(0, len(stack), 8):
            out = models[0].denoise_batch(stack[start:start + 8])
            if normalize:
                out = ((out - out.mean(dim=(1, 2), keepdim=True))
                       / _std(out, dim=(1, 2), keepdim=True))
            denoised[start:start + len(out)] = out.cpu().numpy()
            print(f"# {start + len(out)} of {len(stack)} completed.",
                  file=sys.stderr, end="\r")
    else:
        denoised = None
        for i in range(len(stack)):
            out_i = denoise_image(
                stack[i], models, lowpass=lowpass, cutoff=pixel_cutoff, gaus=gaus,
                inv_gaus=inv_gaus, deconvolve=deconvolve, deconv_patch=deconv_patch,
                patch_size=patch_size, padding=padding, normalize=normalize,
                downsample=downsample)
            if denoised is None:
                denoised = np.zeros((len(stack),) + out_i.shape, dtype=np.float32)
            denoised[i] = out_i
            print(f"# {i + 1} of {len(stack)} completed.", file=sys.stderr, end="\r")
    print("", file=sys.stderr)
    print("# writing to", output_path, file=sys.stderr)
    mrc.write(output_path, denoised, header=header, extended_header=ext_header)
    return denoised


# ---------------------------------------------------------------------------
# CLI glue
# ---------------------------------------------------------------------------

def denoise_main(args):
    """topaz denoise, inference (topaz/commands/denoise.py:75-130)."""
    if args.dir_a is not None or args.dir_b is not None or args.hdf is not None:
        raise NotImplementedError(
            "denoiser training (-a/-b, --hdf) is not yet ported to "
            "topaz_tpu_torch (ROADMAP P11)")
    device = resolve_device(args.device)
    models = []
    for name in args.model:
        if name == "none":
            print("# Warning: no denoising model will be used", file=sys.stderr)
            continue
        print("# Loading model:", name, file=sys.stderr)
        models.append(Denoise(name, device=device, dtype=args.precision))
    if not models or len(args.micrographs) < 1:
        return

    normalize = True if args.format_ in ("png", "jpg") else args.normalize
    gaus = args.gaussian if args.gaussian > 0 else None
    inv_gaus = args.inv_gaussian if args.inv_gaussian > 0 else None
    kw = dict(lowpass=args.lowpass, pixel_cutoff=args.pixel_cutoff, gaus=gaus,
              inv_gaus=inv_gaus, deconvolve=args.deconvolve,
              deconv_patch=args.deconv_patch, patch_size=args.patch_size,
              padding=args.patch_padding, normalize=normalize,
              downsample=args.downsample)
    if args.stack:
        return denoise_stack(args.micrographs[0], args.output, models, **kw)
    return denoise_stream(args.micrographs, args.output, args.format_, args.suffix,
                          models, **kw)
