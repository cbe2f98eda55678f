"""Denoising workflows for 2D micrographs and 3D tomograms, and noise2noise
training (port of topaz_tpu/denoise.py, the reference's topaz/denoise.py and
topaz/commands/denoise.py, denoise3d.py).

Each micrograph is uploaded once; the filter pipeline (lowpass ->
normalize and pixel cutoff -> gaussian, inverse gaussian or whitening
deconvolution -> model average -> rescale) and the model run on the
device, and the denoised image is copied back once; both copies go through
pinned host memory (``transfer.as_device_tensor``, ``transfer.to_host``).
Whole-image denoising normalizes by the image's own statistics. Patch
denoising cuts every patch from the resident micrograph, normalizes each
by its own statistics, as the reference does (topaz/denoise.py:299-324),
and writes its centre into a device output. Standard deviations are
population ones (ddof 0), as in numpy and JAX.

Tomograms (``Denoise3D``) take the volume's statistics, then each padded
patch's own. Up to ``_DEVICE_RESIDENT_CAP`` bytes the volume is uploaded
and zero-padded once, every patch is cut and written back on the device
and the result is fetched once; larger volumes, or a resident run that
exhausts device memory, stream batches of host-cut patches instead. Each
route records ``denoise3d/*`` stage spans and counts its work in this
module's counters (``patches_denoised`` and the rest).
Training (``train_denoiser``) runs an eager autograd step a batch and keeps
the losses on the device until the epoch ends.

With several ``devices`` (``-d -2``, parallel/devices.py) whole images and
tomograms are denoised split by rows over them with halos
(parallel/mesh.make_halo_denoiser), frame batches, 3D patch batches and
training batches are split over them with a copy of the model on each, as
the JAX package shards them over its mesh.
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.io.image import load_image, save_image
from topaz_tpu_torch.models.denoise import min_input_size
from topaz_tpu_torch.models.denoise_factory import (
    denoiser_from_numpy,
    load_denoiser,
    new_denoiser,
    save_denoiser,
)
from topaz_tpu_torch.ops import fourier
from topaz_tpu_torch.parallel.devices import data_mesh_for, resolve_devices
from topaz_tpu_torch.parallel.mesh import (make_halo_denoiser, make_mesh, replicas,
                                           split_apply, summed_grads, sync_replicas)
from topaz_tpu_torch.ops.filters import (
    apply_kernel,
    correct_spatial_covariance,
    gaussian_denoise_kernel,
    inv_gaussian_kernel,
)
from topaz_tpu_torch.train.trainer import make_optimizer
from topaz_tpu_torch.transfer import as_device_tensor, to_host
from topaz_tpu_torch.utils.profiling import stage


# Denoise3D's work in this process, as transfer.py counts its copies:
# patches denoised, voxels through the network (padded patches, a streaming
# batch's fill copies, whole volumes), voxels of output, and patched volumes
# by route; callers may reset each to 0
patches_denoised = 0
network_voxels = 0
output_voxels = 0
resident_volumes = 0
streaming_volumes = 0


def _count_volume(route: Optional[str], patches: int, network: int, output: int) -> None:
    global patches_denoised, network_voxels, output_voxels, resident_volumes, streaming_volumes
    patches_denoised += patches
    network_voxels += network
    output_voxels += output
    if route == "resident":
        resident_volumes += 1
    elif route == "streaming":
        streaming_volumes += 1


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
    return float32 tensors on ``self.device``. The model comes from an
    alias or checkpoint path (``model``), a JAX parameter tree (``meta``,
    ``params``) or a module (``net``). ``last_route`` names the route the
    last ``denoise_batch`` took: "batched" (one forward) or "frames" (one
    frame at a time, after the batch ran out of device memory).
    ``devices`` (two or more; the first is ``device``) split whole images
    by rows and frame batches over them (the JAX package's ``devices``)."""

    dims = 2
    last_route = None

    def __init__(self, model: str = "unet", device="cuda", *, meta=None,
                 params=None, dtype=None, net=None, devices=None):
        if dtype not in (None, "f32", "bf16"):
            raise ValueError(f"unsupported denoise dtype {dtype!r}: use f32 or bf16")
        self.devices = [torch.device(d) for d in devices] if devices else None
        self.device = resolve_device(self.devices[0] if self.devices else device)
        if net is None:
            net = (denoiser_from_numpy(meta, params) if meta is not None
                   else load_denoiser(model, device=self.device))
        if net.meta.get("dims", 2) != self.dims:
            raise ValueError(f"{type(self).__name__} needs a {self.dims}D denoiser, got a "
                             f"{net.meta.get('dims', 2)}D {net.meta['arch']!r}")
        self.meta = net.meta
        self.dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
        self.model = net.to(device=self.device, dtype=self.dtype)
        # smallest whole-image pixel count that ran out of device memory in
        # this instance; images this large go straight to patches
        self._oom_area = None
        self._halo_fns = {}  # (padded shape, shards, halo) -> halo denoiser
        self._copies = {}    # the model's copies on the other devices

    @classmethod
    def from_arch(cls, arch: str, device="cuda", dtype=None, devices=None, **arch_kw):
        """An untrained denoiser from an architecture name (the reference's
        fresh-model branch, topaz/commands/denoise.py:88-98); ``arch_kw``
        are ``new_denoiser``'s nf, base_width, top_width and seed."""
        return cls(device=device, dtype=dtype, devices=devices,
                   net=new_denoiser(arch, dims=cls.dims, **arch_kw))

    def _normalized_forward(self, xb: torch.Tensor, model=None) -> torch.Tensor:
        """(B, *spatial) frames or patches, each normalized by its own mean
        and std, denoised (by ``model``, default this denoiser's), and
        restored to its own scale."""
        axes = tuple(range(1, xb.ndim))
        mu = xb.mean(dim=axes, keepdim=True)
        std = _std(xb, dim=axes, keepdim=True)
        with torch.inference_mode():
            y = (model or self.model)(((xb - mu) / std)[:, None].to(self.dtype))[:, 0]
        return y.float() * std + mu

    def _sharded_forward(self, xb: torch.Tensor) -> torch.Tensor:
        """``_normalized_forward`` with the batch split over the data mesh
        of ``devices`` that divides it (one device when none does)."""
        mesh = data_mesh_for(self.devices, xb.shape[0])
        devices = mesh.data_devices if mesh is not None else [self.device]
        reps = replicas(self.model, devices, self._copies)
        return split_apply(lambda i, dev, x: self._normalized_forward(x, reps[i]), devices, xb,
                           out_device=self.device)

    # a shard (and its aprons) must survive the deepest U-Net's five 2x
    # pooling levels, so never shard below this many leading rows
    _MIN_HALO_BLOCK = 32

    def _apply_halo(self, x: torch.Tensor):
        """Whole-image denoising with the rows (z-slabs in 3D) split over
        ``devices`` (topaz_tpu/denoise.py:128-159): as many shards as give
        each at least 32 rows, the image padded by edge rows to a multiple
        of them, a halo of up to 256 rows. None (the caller uses one device)
        below two shards."""
        if self.devices is None or len(self.devices) < 2:
            return None
        n = min(len(self.devices), max(1, x.shape[0] // self._MIN_HALO_BLOCK))
        if n < 2:
            return None
        pad = (-x.shape[0]) % n
        xp = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))]) if pad else x
        halo = max(1, min(256, xp.shape[0] // n))
        key = (tuple(xp.shape), n, halo)
        if key not in self._halo_fns:
            self._halo_fns[key] = make_halo_denoiser(
                self.model, make_mesh(n_data=1, n_space=n, devices=self.devices[:n]),
                halo=halo)
        return self._halo_fns[key](xp)[: x.shape[0]]

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        """Denoise one whole image with its own statistics
        (topaz/denoise.py:274-296). In 2D a device out-of-memory falls back
        to patch denoising with a warning, on the same device."""
        y = self._apply_halo(x)
        if y is not None:
            return y
        if self._oom_area is not None and x.numel() >= self._oom_area:
            return self._patch_fallback(x)
        try:
            return self._normalized_forward(x[None])[0]
        except torch.cuda.OutOfMemoryError as e:
            if self.dims != 2:
                raise
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
            out = self._sharded_forward(frames)
            self.last_route = "batched"
            return out
        except torch.cuda.OutOfMemoryError:
            pass
        if frames.is_cuda:
            torch.cuda.empty_cache()
        print(f"# WARNING: batched denoising of {tuple(frames.shape)} exceeds "
              f"device memory; denoising frames one at a time", file=sys.stderr)
        self.last_route = "frames"
        return torch.stack([self._apply(f) for f in frames])

    def train(self, train_sampler, val_sampler, **kw):
        """noise2noise training of this denoiser's model in place
        (``train_denoiser``'s keywords)."""
        if self.dtype != torch.float32:
            raise ValueError("denoiser training runs in float32; load the model without bf16")
        train_denoiser(self.model, train_sampler, val_sampler, dims=self.dims,
                       devices=self.devices, **kw)


def auto_patch_size(shape, padding: int = 48, max_extent: int = 256,
                    align: int = 32) -> int:
    """The 3D inference patch size that minimizes the voxels processed
    (topaz_tpu/denoise.py:445-479): among patch sizes whose padded extent
    d = s + 2 * padding is a multiple of ``align`` and at most
    ``max_extent``, the one with the least n_patches * d^3, the larger on a
    tie. The reference defaults (-s 96 -p 48) process (96 + 96)^3 voxels for
    each 96^3 of output, and a patch that does not divide the tomogram adds
    the overshoot of a ceiling grid."""
    best = None
    s0 = (-2 * padding) % align
    while s0 < align:  # patches below one alignment step are pure overlap
        s0 += align
    for s in range(s0, max_extent - 2 * padding + 1, align):
        d = s + 2 * padding
        n_patches = 1
        for n in shape:
            n_patches *= -(-int(n) // s)
        cost = n_patches * d**3
        if best is None or cost < best[0] or (cost == best[0] and s > best[1]):
            best = (cost, s)
    if best is None:
        raise ValueError(
            f"--auto-patch cannot satisfy padding {padding}: the padded "
            f"patch extent would exceed the limit {max_extent} "
            f"(largest supported padding is {(max_extent - align) // 2}); "
            f"lower -p or pass an explicit patch size with -s")
    return best[1]


class Denoise3D(Denoise):
    """Tomogram denoiser (topaz/denoise.py:336-377). ``denoise`` returns a
    float32 numpy volume; ``last_route`` names the route its last patched
    call took ("resident" or "streaming")."""

    dims = 3

    # largest volume kept resident on the device beside its padded copy,
    # its output and one padded patch's activations (the JAX package's cap)
    _DEVICE_RESIDENT_CAP = 512 * 1024 * 1024

    last_route = None

    def _denoise_resident(self, tomo: np.ndarray, patch_size: int, padding: int,
                          verbose: bool = True):
        """Patch denoising with the volume resident on the device: upload
        and zero-pad it once, cut each padded patch there, apply the volume's
        and the patch's statistics, write the patch's centre into a device
        output, and fetch it once. Returns None (the caller streams) with
        several devices (the streaming route splits its batches over them),
        over the residency cap or when the device runs out of memory."""
        if data_mesh_for(self.devices) is not None or tomo.nbytes > self._DEVICE_RESIDENT_CAP:
            return None
        s, p = patch_size, padding
        ext = [-(-int(n) // s) * s for n in tomo.shape]
        origins = [(i, j, k) for i in range(0, ext[0], s) for j in range(0, ext[1], s)
                   for k in range(0, ext[2], s)]
        if verbose:
            print(f"# device-resident: {len(origins)} patches of {s + 2 * p}^3", file=sys.stderr)
        try:
            return self._resident_run(tomo, s, p, ext, origins)
        except torch.cuda.OutOfMemoryError:
            pass  # the failed run's tensors go with its frame
        torch.cuda.empty_cache()
        if verbose:
            print("# device-resident volume OOM; falling back to the streaming patch path",
                  file=sys.stderr)
        return None

    def _resident_run(self, tomo, s, p, ext, origins) -> np.ndarray:
        """The resident route's work, in stage spans: ``denoise3d/upload``
        (the volume, its statistics and its zero-padded copy), one
        ``denoise3d/patch`` a patch (cut, the volume's normalisation, the
        centre written back) around its ``denoise3d/unet`` forward, and
        ``denoise3d/fetch``."""
        d = s + 2 * p
        shape = tomo.shape
        pad = []
        for e, n in zip(reversed(ext), reversed(shape)):  # F.pad lists the last axis first
            pad += [p, p + e - n]
        with stage("denoise3d/upload", device=self.device):
            vol = as_device_tensor(tomo, self.device)
            mu, std = vol.mean(), _std(vol)
            volp = F.pad(vol, pad)  # zero fill, as the streaming route's patches
        out = torch.empty(ext, device=self.device)
        for i, j, k in origins:
            with stage("denoise3d/patch", device=self.device):
                xn = (volp[i:i + d, j:j + d, k:k + d] - mu) / std
                with stage("denoise3d/unet", device=self.device):
                    y = self._normalized_forward(xn[None])[0]
                out[i:i + s, j:j + s, k:k + s] = y[p:p + s, p:p + s, p:p + s] * std + mu
        with stage("denoise3d/fetch"):
            out = to_host(out[:shape[0], :shape[1], :shape[2]].contiguous())
        _count_volume("resident", len(origins), len(origins) * d ** 3, out.size)
        return out

    def _denoise_streaming(self, tomo: np.ndarray, patch_size: int, padding: int,
                           batch_size: int, volume_num: int, total_volumes: int,
                           verbose: bool) -> np.ndarray:
        """Host patch loop (topaz/denoise.py:346-377): zero-filled padded
        patches cut on the host, normalized by the volume's statistics,
        denoised ``batch_size`` at a time with their own statistics (the last
        batch filled with copies of its last patch), centres stitched on the
        host. With several devices the batch grows to a multiple of their
        count and is split over them. A batch's stage spans:
        ``denoise3d/extract`` (cut and normalised on the host),
        ``denoise3d/upload``, ``denoise3d/unet``, ``denoise3d/fetch`` and
        ``denoise3d/stitch``."""
        mesh = data_mesh_for(self.devices)
        if mesh is not None:
            n_data = mesh.shape["data"]
            batch_size = max(batch_size, n_data)
            batch_size += (-batch_size) % n_data
        mu, std = tomo.mean(), tomo.std()
        denoised = np.zeros_like(tomo)
        d = patch_size + 2 * padding
        grid = [int(np.ceil(n / patch_size)) for n in tomo.shape]
        total, count = int(np.prod(grid)), 0

        def extract_patch(i, j, k):
            x = np.zeros((d, d, d), dtype=np.float32)
            lo = [max(0, c - padding) for c in (i, j, k)]
            hi = [min(n, c + patch_size + padding) for c, n in zip((i, j, k), tomo.shape)]
            x[tuple(slice(padding - c + a, padding - c + b)
                    for c, a, b in zip((i, j, k), lo, hi))] = \
                tomo[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            return x

        origins = [(pi * patch_size, pj * patch_size, pk * patch_size)
                   for pi in range(grid[0]) for pj in range(grid[1]) for pk in range(grid[2])]
        for start in range(0, len(origins), batch_size):
            chunk = origins[start:start + batch_size]
            with stage("denoise3d/extract"):
                xs = [extract_patch(*o) for o in chunk]
                while len(xs) < batch_size:
                    xs.append(xs[-1])
                xn = (np.stack(xs) - mu) / std
            with stage("denoise3d/upload", device=self.device):
                xb = torch.from_numpy(xn).to(self.device)
            with stage("denoise3d/unet", device=self.device):
                yb = self._sharded_forward(xb)
            with stage("denoise3d/fetch"):
                ys = yb.cpu().numpy()
            with stage("denoise3d/stitch"):
                ys = ys * std + mu
                for (i, j, k), y in zip(chunk, ys):
                    patch = denoised[i:i + patch_size, j:j + patch_size, k:k + patch_size]
                    pz, py, px = patch.shape
                    patch[...] = y[padding:padding + pz, padding:padding + py,
                                   padding:padding + px]
                    count += 1
                    if verbose:
                        print(f"# [{volume_num}/{total_volumes}] {round(count * 100 / total)}%",
                              file=sys.stderr, end="\r")
        if verbose:
            print(" " * 100, file=sys.stderr, end="\r")
        batches = -(-len(origins) // batch_size)
        _count_volume("streaming", len(origins), batches * batch_size * d ** 3, denoised.size)
        return denoised

    def denoise(self, tomo, patch_size: int = 96, padding: int = 48, batch_size: int = 1,
                volume_num: int = 1, total_volumes: int = 1, verbose: bool = True,
                device_resident=None) -> np.ndarray:
        """Denoise one volume, whole (``patch_size < 1``) or in patches;
        ``patch_size == -2`` picks ``auto_patch_size``. ``device_resident``
        None routes by size, True requires the resident route, False
        streams."""
        tomo = np.asarray(tomo, dtype=np.float32)
        if patch_size == -2:
            patch_size = auto_patch_size(tomo.shape, padding=padding)
            if verbose:
                print(f"# auto patch size {patch_size} for volume {tuple(tomo.shape)} "
                      f"(padding {padding})", file=sys.stderr)
        if patch_size < 1:
            with stage("denoise3d/upload", device=self.device):
                x = as_device_tensor(tomo, self.device)
            with stage("denoise3d/unet", device=self.device):
                y = self._apply(x)
            with stage("denoise3d/fetch"):
                out = to_host(y)
            _count_volume(None, 0, tomo.size, out.size)
            return out
        _check_min_extent(self.meta, (patch_size + 2 * padding,) * 3,
                          "inference patches", "-s/--patch-size")
        if device_resident is not False:
            out = self._denoise_resident(tomo, patch_size, padding, verbose=verbose)
            if out is not None:
                self.last_route = "resident"
                return out
            if device_resident:
                raise ValueError("device_resident=True requested but the volume cannot stay "
                                 "resident (several devices, over the residency cap or out "
                                 "of device memory)")
        self.last_route = "streaming"
        return self._denoise_streaming(tomo, patch_size, padding, batch_size, volume_num,
                                       total_volumes, verbose)


# ---------------------------------------------------------------------------
# noise2noise training (topaz/denoising/models.py:636-758)
# ---------------------------------------------------------------------------

LOSSES = ("L0", "L1", "L2")


def denoise_loss(loss_fn: str, pred: torch.Tensor, target: torch.Tensor,
                 gamma: float) -> torch.Tensor:
    """The noise2noise criteria: L0 (annealed by ``gamma``), L1 and L2."""
    if loss_fn == "L0":
        return torch.mean((torch.abs(pred - target) + 1e-8) ** gamma)
    if loss_fn == "L1":
        return torch.mean(torch.abs(pred - target))
    if loss_fn == "L2":
        return torch.mean((pred - target) ** 2)
    raise ValueError(f"Loss function: {loss_fn} not one of [L0, L1, L2].")


def make_denoise_optimizer(model: torch.nn.Module, optim: str = "adagrad", lr: float = 0.001,
                           weight_decay: float = 0):
    """The denoiser's optimizer (topaz_tpu/denoise.py:735-740): sgd always
    with momentum 0.9 and nesterov, whatever ``--momentum`` says; weight
    decay added to the gradient first."""
    params = list(model.parameters())
    if optim == "sgd":
        return make_optimizer(params, lr, "sgd", momentum=0.9, nesterov=True,
                              weight_decay=weight_decay)
    return make_optimizer(params, lr, optim, weight_decay=weight_decay)


def make_denoise_step(model: torch.nn.Module, optimizer, loss_fn: str = "L2", mesh=None):
    """``step(src, tgt, gamma) -> loss``: one eager autograd step on (B,
    *spatial) device tensors, updating the model in place. The loss stays on
    the device. With a data ``mesh`` each device forwards its share of the
    batch through its copy of the model, the loss is the whole batch's and
    the copies' gradients are summed into the model's."""
    params = optimizer.params
    copies: dict = {}

    def step(src: torch.Tensor, tgt: torch.Tensor, gamma: float) -> torch.Tensor:
        devices = mesh.data_devices if mesh is not None else [src.device]
        reps = replicas(model, devices, copies)
        sync_replicas(model, reps)
        pred = split_apply(lambda i, dev, x: reps[i](x[:, None])[:, 0], devices, src,
                           out_device=src.device)
        loss = denoise_loss(loss_fn, pred, tgt, gamma)
        optimizer.step(summed_grads(loss, params, reps))
        return loss.detach()

    return step


def _weighted_mean(losses: List[torch.Tensor], weights: List[int]) -> float:
    """Batch losses (device scalars) weighted by batch size, in float64 on
    the host: one fetch an epoch."""
    if not losses:
        return 0.0
    vals = torch.stack(losses).double().cpu().numpy()
    w = np.asarray(weights, dtype=np.float64)
    return float((vals * w).sum() / w.sum())


def train_denoiser(model: torch.nn.Module, train_sampler, val_sampler, loss_fn: str = "L2",
                   optim: str = "adagrad", lr: float = 0.001, weight_decay: float = 0,
                   batch_size: int = 10, num_epochs: int = 500, num_workers: int = 1,
                   verbose: bool = True, save_best: bool = False,
                   save_interval: Optional[int] = None, save_prefix: Optional[str] = None,
                   dims: int = 2, devices=None) -> torch.nn.Module:
    """noise2noise training (topaz_tpu/denoise.py:685-840) of ``model`` in
    place, on its device: L0 (annealed), L1 or L2; adagrad, adam or sgd;
    save-best on the validation loss and every ``save_interval`` epochs to
    ``<save_prefix>_epoch<n>.npz``. Rows go to stdout as the JAX package
    prints them. ``num_workers`` is a compatibility argument. Each epoch
    runs in a ``stage("denoise_train_epoch")`` span. With several
    ``devices`` the training batches are split over the data mesh that
    divides ``batch_size`` (topaz_tpu/denoise.py:703-709)."""
    if loss_fn not in LOSSES:
        raise ValueError(f"Loss function: {loss_fn} not one of [L0, L1, L2].")
    output, log = sys.stdout, sys.stderr
    device = next(model.parameters()).device
    meta = model.meta
    digits = int(np.ceil(np.log10(max(num_epochs, 2))))
    if save_prefix is not None:
        save_dir = os.path.dirname(save_prefix)
        if save_dir and not os.path.exists(save_dir):
            print("# creating save directory:", save_dir, file=log)
            os.makedirs(save_dir)

    start_time = time.time()
    now = datetime.datetime.now()
    print(f"# starting time: {now.month:02d}/{now.day:02d}/{now.year:04d} "
          f"{now.hour:02d}h:{now.minute:02d}m:{now.second:02d}s", file=log)

    mesh = data_mesh_for(devices, batch_size, warn=True)
    if mesh is not None:
        print(f"# training sharded over {mesh.shape['data']} devices", file=log)
    optimizer = make_denoise_optimizer(model, optim, lr, weight_decay)
    step = make_denoise_step(model, optimizer, loss_fn, mesh=mesh)

    print("# training model...", file=log)
    if verbose:
        print("\t".join(["Epoch", "Train Loss", "Val Loss", "Best Val Loss"]), file=output)

    def _save(epoch):
        save_denoiser(save_prefix + f"_epoch{epoch:0{digits}}.npz", meta, model)

    best_val = np.inf
    for epoch in range(num_epochs):
        gamma = 2 - (epoch - 1) * 2 / num_epochs if loss_fn == "L0" else 2.0
        with stage("denoise_train_epoch"):
            losses, weights = [], []
            for src, tgt in train_sampler.batches(batch_size, shuffle=True):
                if epoch == 0 and not weights:
                    _check_min_extent(meta, src.shape[1:1 + dims], "training tiles",
                                      "--crop/-c")
                losses.append(step(as_device_tensor(src, device), as_device_tensor(tgt, device),
                                   gamma))
                weights.append(src.shape[0])
            if epoch == 0 and not weights:
                raise ValueError(
                    "the training sampler produced no batches — check that the paired "
                    "training data is non-empty and larger than the crop/tile size")
            train_loss = _weighted_mean(losses, weights)

            losses, weights = [], []
            with torch.no_grad():
                for src, tgt in val_sampler.batches(batch_size, shuffle=False):
                    pred = model(as_device_tensor(src, device)[:, None])[:, 0]
                    losses.append(denoise_loss(loss_fn, pred, as_device_tensor(tgt, device),
                                               gamma))
                    weights.append(src.shape[0])
            val_loss = _weighted_mean(losses, weights)

        if val_loss < best_val:
            best_val = val_loss
            if save_best and save_prefix is not None:
                _save(epoch + 1)
        if verbose:
            vals = (train_loss, val_loss, best_val)
            print("\t".join([f"# [{epoch}/{num_epochs}]"] + [str(round(v, 5)) for v in vals]),
                  file=output, end="\r")
        if save_prefix is not None and save_interval is not None \
                and (epoch + 1) % save_interval == 0:
            _save(epoch + 1)

    print("# training completed!", file=log)
    print("# total time:", time.strftime("%Hh:%Mm:%Ss", time.gmtime(time.time() - start_time)),
          file=log)
    return model


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
    with stage("denoise/upload", device=device):
        x = as_device_tensor(mic, device)
    with stage("denoise/filter", device=device):
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

    with stage("denoise/unet", device=device):
        out = sum(model.denoise(x, patch_size=patch_size, padding=padding)
                  for model in models) / len(models)
        if normalize:
            out = (out - out.mean()) / _std(out)
        else:
            out = std * out + mu
    with stage("denoise/fetch"):
        return to_host(out)


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
# 3D drivers (topaz/denoise.py:495-557)
# ---------------------------------------------------------------------------

def denoise_tomogram(path: str, model: Denoise3D, outdir: Optional[str] = None,
                     suffix: str = "", patch_size: int = 96, padding: int = 48,
                     volume_num: int = 1, total_volumes: int = 1,
                     gaus: Optional[float] = None, verbose: bool = True) -> np.ndarray:
    """Denoise one tomogram file, optionally Gaussian-filter the result on
    the device, and write it as float32 with its header's min, max and mean
    updated (topaz/denoise.py:495-530). Without ``outdir`` the output goes
    beside the input as ``<name><suffix or .denoised><ext>``. The denoising
    runs in a ``stage("denoise3d_volume")`` span."""
    name = os.path.basename(path)
    tomo, header, ext_header = mrc.read(path)
    with stage("denoise3d_volume"):
        denoised = model.denoise(tomo.astype(np.float32), patch_size=patch_size,
                                 padding=padding, volume_num=volume_num,
                                 total_volumes=total_volumes, verbose=verbose)
        if gaus is not None:
            denoised = apply_kernel(denoised, gaussian_denoise_kernel(gaus, dims=3),
                                    device=model.device, dims=3).cpu().numpy()
    if not outdir:
        no_ext, ext = os.path.splitext(path)
        outpath = no_ext + (suffix or ".denoised") + ext
    else:
        no_ext, ext = os.path.splitext(name)
        outpath = os.path.join(outdir, no_ext + suffix + ext)
    header = header.replace(mode=2, amin=denoised.min(), amax=denoised.max(),
                            amean=denoised.mean())
    mrc.write(outpath, denoised, header=header, extended_header=ext_header)
    return denoised


def denoise_tomogram_stream(volumes: List[str], model: Denoise3D, output_path: str,
                            suffix: str = "", gaus: Optional[float] = None,
                            patch_size: int = 96, padding: int = 48, verbose: bool = True):
    """Denoise a list of tomogram files (topaz/denoise.py:533-557). Each
    output is written, not kept: a session's tomograms would not fit in
    host memory."""
    total = len(volumes)
    if output_path:
        os.makedirs(output_path, exist_ok=True)
    g = gaus if (gaus or 0) > 0 else None
    for idx, path in enumerate(volumes):
        denoise_tomogram(path, model, outdir=output_path, suffix=suffix, patch_size=patch_size,
                         padding=padding, volume_num=idx + 1, total_volumes=total, gaus=g,
                         verbose=verbose)
        print(f"# {idx + 1} of {total} tomograms denoised.", file=sys.stderr, end="\r")
    print("", file=sys.stderr)


# ---------------------------------------------------------------------------
# CLI glue
# ---------------------------------------------------------------------------

def _train_pair_given(a, b, flags: str) -> bool:
    """True when both halves of a training pair were given; one alone is an
    error here, where the JAX CLI ignores it (2D) or fails inside the
    sampler (3D)."""
    if (a is None) != (b is None):
        sys.exit(f"error: denoiser training needs both {flags}")
    return a is not None


def denoise_main(args):
    """topaz denoise (topaz/commands/denoise.py:75-130): with -a/-b or
    --hdf, train the --arch model (the bundled weights where --arch names
    them) and denoise with it; otherwise denoise with the -m models. With
    several devices (-d -2) each micrograph is denoised whole, split by rows
    over them, instead of in patches."""
    devices = resolve_devices(args.device)
    device = devices[0]
    if len(devices) > 1:
        print(f"# denoising sharded over {len(devices)} devices", file=sys.stderr)
        args.patch_size = -1
    else:
        devices = None
    do_train = _train_pair_given(args.dir_a, args.dir_b, "-a/--dir-a and -b/--dir-b")
    if do_train or args.hdf is not None:
        from topaz_tpu_torch.train.denoise_data import (make_hdf5_samplers,
                                                        make_paired_images_samplers)

        try:
            denoiser = Denoise(args.arch, device=device, devices=devices)
        except FileNotFoundError:
            denoiser = Denoise.from_arch(args.arch, device=device, devices=devices)
        if args.hdf is None:
            train_s, val_s = make_paired_images_samplers(
                args.dir_a, args.dir_b, crop=args.crop, holdout=args.holdout,
                cutoff=args.pixel_cutoff)
        else:
            train_s, val_s = make_hdf5_samplers(args.hdf, holdout=args.holdout,
                                                cutoff=args.pixel_cutoff)
        denoiser.train(train_s, val_s, loss_fn=args.criteria, optim=args.optim, lr=args.lr,
                       batch_size=args.batch_size, num_epochs=args.num_epochs, save_best=True,
                       save_interval=args.save_interval, save_prefix=args.save_prefix)
        models = [denoiser]
    else:
        models = []
        for name in args.model:
            if name == "none":
                print("# Warning: no denoising model will be used", file=sys.stderr)
                continue
            print("# Loading model:", name, file=sys.stderr)
            models.append(Denoise(name, device=device, dtype=args.precision, devices=devices))
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


class _TileSampler:
    """One mode ("train" or "test") of a ``PairedTiles3D``, with the
    ``batches(batch_size, shuffle)`` interface of the 2D samplers."""

    def __init__(self, data, mode: str):
        self.data, self.mode = data, mode

    def batches(self, batch_size: int, shuffle: bool = True):
        return self.data.batches(batch_size, mode=self.mode, shuffle=shuffle)


def denoise3d_main(args):
    """topaz denoise3d (topaz/commands/denoise3d.py:88-130): with -a/-b,
    train (the -m model if it loads, else a fresh 3D unet) on even/odd tile
    pairs; then denoise the volumes. With several devices (-d -2, the
    default) training batches and patch batches are split over them."""
    devices = resolve_devices(args.device)
    device = devices[0]
    if len(devices) > 1:
        print(f"# denoising on {len(devices)} devices", file=sys.stderr)
    else:
        devices = None
    if _train_pair_given(args.even_train_path, args.odd_train_path,
                         "-a/--even-train-path and -b/--odd-train-path"):
        from topaz_tpu_torch.train.denoise_data import PairedTiles3D

        try:
            denoiser = Denoise3D(args.model, device=device, devices=devices)
        except FileNotFoundError:
            denoiser = Denoise3D.from_arch("unet", device=device, devices=devices,
                                           base_width=args.base_kernel_width)
        data = PairedTiles3D(args.even_train_path, args.odd_train_path, args.crop,
                             args.N_train, args.N_test)
        denoiser.train(_TileSampler(data, "train"), _TileSampler(data, "test"),
                       loss_fn=args.criteria, optim=args.optim, lr=args.lr,
                       weight_decay=args.weight_decay, batch_size=args.batch_size,
                       num_epochs=args.num_epochs, save_best=True,
                       save_interval=args.save_interval, save_prefix=args.save_prefix)
    else:
        if args.model == "none":
            print("# Warning: no denoising model will be used", file=sys.stderr)
            return
        print("# Loading model:", args.model, file=sys.stderr)
        try:
            denoiser = Denoise3D(args.model, device=device, dtype=args.precision,
                                 devices=devices)
        except FileNotFoundError as e:
            print(f"Error: {e}", file=sys.stderr)
            print("Hint: the 3D pretrained weights are not bundled in this installation; "
                  "train a model with -a/--even-train-path and -b/--odd-train-path, then "
                  "pass it with -m.", file=sys.stderr)
            sys.exit(1)

    if len(args.volumes) < 1:
        return
    shown = "auto" if args.patch_size == -2 else args.patch_size
    print(f"# denoising {len(args.volumes)} tomograms with patch size={shown} and "
          f"padding={args.patch_padding}", file=sys.stderr)
    denoise_tomogram_stream(args.volumes, denoiser, args.output, suffix=args.suffix,
                            gaus=args.gaussian, patch_size=args.patch_size,
                            padding=args.patch_padding)
