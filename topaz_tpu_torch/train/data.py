"""Host-side training data: random crops from memory-mapped micrographs and
tomograms (port of topaz_tpu/train/data.py:40-341, without pandas).

``CropSampler`` is host numpy, seeded by ``np.random.default_rng(seed)``.
It draws from its generator exactly as the JAX package's sampler does, so
that with the same seed and the same files it hands out the same crops and
labels, bit for bit. Sampling follows the reference
(topaz/utils/data/memory_mapped_data.py:79-233, topaz/training.py:447-476):
  * positives are uniform over the particle centers dilated to the radius
    disk;
  * unlabeled ('pu' split) crops center on any pixel; negative ('pn' split)
    crops center on any pixel that is not a labeled positive;
  * crops are zero outside the image.
The caller draws the batch's positive count (Binomial(B, balance), the
reference's per-item ``positive_balance``) from the sampler's generator.
2D crops come from the C gather (``train/cropgather.py``); its numpy
versions here (``native=False``) serve the tests only. 3D windows come from
``_gather_crops_3d`` on the host, as the JAX package cuts them, or, in
training, from ``ResidentVolumes``: the tomograms uploaded once, zero-padded,
and the same windows cut on the device from the positions the sampler drew
(``sample_positions``), so that a batch of 256 windows of 71 x 101 x 101
voxels (742 MB) is neither copied on the host nor uploaded every step.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from topaz_tpu_torch.io.coordinates import Coordinates
from topaz_tpu_torch.io.mrc import MrcMemmap
from topaz_tpu_torch.io.table import parse_column
from topaz_tpu_torch.utils.printing import report


def sphere_offsets(radius: float, dims: int = 2) -> np.ndarray:
    """Integer offsets (n, [dx, dy]) within ``radius`` of the origin, or
    (n, [dx, dy, dz]) in 3D (training.py:449-466), in the JAX package's
    order."""
    R = int(math.floor(radius))
    grid = np.arange(-R, R + 1)
    if dims == 2:
        d2 = grid[:, None] ** 2 + grid[None, :] ** 2
        ys, xs = np.nonzero(d2 <= radius**2)
        return np.stack([grid[xs], grid[ys]], axis=1)
    d2 = grid[:, None, None] ** 2 + grid[None, :, None] ** 2 + grid[None, None, :] ** 2
    zs, ys, xs = np.nonzero(d2 <= radius**2)
    return np.stack([grid[xs], grid[ys], grid[zs]], axis=1)


def expand_target_points(targets: Coordinates, radius: float,
                         dims: int = 2) -> Tuple[Coordinates, int]:
    """Particle centers expanded to every pixel (voxel) within ``radius``
    (training.py:447-476): (expanded table, pixels a particle)."""
    offs = sphere_offsets(radius, dims)
    n, k = len(targets), len(offs)

    def expand(column, axis):
        return np.repeat(column, k) + np.tile(offs[:, axis], n)

    return Coordinates(np.repeat(targets.image_name, k), expand(targets.x_coord, 0),
                       expand(targets.y_coord, 1),
                       z_coord=expand(targets.z_coord, 2) if dims == 3 else None), k


def _read_image_list(path: str) -> Dict[str, np.ndarray]:
    """An image list file as {column: array}: tab-separated first, so that
    paths with spaces survive; whitespace-separated when the tab parse has
    no complete 'path' column or ragged rows (find_image_paths of the JAX
    package)."""
    with open(path) as f:
        lines = [line.rstrip("\r\n") for line in f if line.strip()]
    for split in (lambda line: line.split("\t"), str.split):
        header, rows = split(lines[0]), [split(line) for line in lines[1:]]
        if "path" in header and all(len(r) == len(header) and r[header.index("path")]
                                    for r in rows):
            break
    else:
        raise ValueError(f"{path}: an image list needs a 'path' column")
    return {name: (np.array([r[i] for r in rows], dtype=object)
                   if name in ("image_name", "path") else parse_column([r[i] for r in rows]))
            for i, name in enumerate(header)}


def find_image_paths(images_path: str, image_ext: str = "") -> Dict[str, np.ndarray]:
    """An image directory or list file as {"image_name", "path"[, "source"]}
    columns (training.py:69-91)."""
    if os.path.isdir(images_path):
        paths = sorted(glob.glob(os.path.join(images_path, "*" + (image_ext or ".mrc"))))
        return {"image_name": np.array([os.path.splitext(os.path.basename(p))[0]
                                        for p in paths], dtype=object),
                "path": np.array(paths, dtype=object)}
    return _read_image_list(images_path)


class CropSampler:
    """Batched random-crop sampler over memory-mapped micrographs, or
    tomograms with ``dims=3``."""

    def __init__(self, image_paths: List[str], targets: Coordinates, crop_size: int,
                 radius: float = 3, split: str = "pn", rotate: bool = True,
                 seed: int = 0, native: bool = True, dims: int = 2):
        self.crop_size = crop_size
        # over-crop so that rotation never clips corners (training.py:172-173)
        size = int(np.ceil(crop_size * np.sqrt(2))) if rotate else crop_size
        if size % 2 == 0:
            size += 1
        self.raw_size = size
        # 3D crops rotate about z only (train/augment.augment_crops_3d), so
        # the z window keeps the crop size
        self.raw_size_z = crop_size if (rotate and dims == 3) else size
        self.augment = rotate and dims == 2
        self.dims = dims
        self.rng = np.random.default_rng(seed)
        self.native = native and dims == 2
        if self.native:
            from topaz_tpu_torch.train.cropgather import load_library

            load_library()  # a failed build raises here, not in a loader thread

        self.images: List[MrcMemmap] = []
        name_to_idx = {}
        for path in image_paths:
            name_to_idx[os.path.splitext(os.path.basename(path))[0]] = len(self.images)
            self.images.append(MrcMemmap(path))

        expanded, self.mask_size = expand_target_points(targets, radius, dims)
        keep = np.array([n in name_to_idx for n in expanded.image_name], dtype=bool)
        missing = list(dict.fromkeys(expanded.image_name[~keep].tolist()))
        if missing:
            report(f"WARNING: {len(missing)} micrographs listed in the "
                   f"coordinates file are missing from the images: {missing}")
        expanded = expanded.take(keep)

        img_idx = np.array([name_to_idx[n] for n in expanded.image_name], dtype=np.int64)
        xs = np.round(expanded.x_coord).astype(np.int64)
        ys = np.round(expanded.y_coord).astype(np.int64)
        zs = (np.round(expanded.z_coord).astype(np.int64) if dims == 3
              else np.zeros(len(img_idx), dtype=np.int64))

        # drop out-of-bounds expanded pixels (memory_mapped_data.py:102-114)
        shapes = np.array([im.shape[-2:] for im in self.images]).reshape(-1, 2)
        in_bounds = ((xs >= 0) & (ys >= 0)
                     & (xs < shapes[img_idx, 1]) & (ys < shapes[img_idx, 0]))
        if dims == 3:
            depths = np.array([im.shape[0] for im in self.images])
            in_bounds &= (zs >= 0) & (zs < depths[img_idx])
        n_oob = int(len(in_bounds) - in_bounds.sum())
        if n_oob:
            # the usual cause is unscaled coordinates against downsampled
            # micrographs (reference warning: memory_mapped_data.py:110-113)
            report(f"WARNING: ~{n_oob} positive pixels are out of bounds "
                   f"for their images. Did you scale the micrographs and "
                   f"particle coordinates correctly?")
        self.pos_img = img_idx[in_bounds]
        self.pos_x = xs[in_bounds]
        self.pos_y = ys[in_bounds]
        self.pos_z = zs[in_bounds]
        self.num_pixels = len(self.pos_img)
        self.num_images = len(self.images)

        # positive-pixel keys for rejecting negatives: a sorted int64 array
        # probed by searchsorted
        packed = self._pack(self.pos_img, self.pos_z, self.pos_y, self.pos_x)
        self.positive_sorted = np.sort(packed) if split == "pn" else None

    @staticmethod
    def _pack(k, z, y, x):
        # numpy int64 on both the keys and the probe: beyond the packed field
        # widths the shifts wrap the same way on both sides
        return ((np.int64(k) << np.int64(48)) | (np.int64(z) << np.int64(34))
                | (np.int64(y) << np.int64(17)) | np.int64(x))

    def _is_positive(self, k, z, y, x) -> bool:
        key = self._pack(k, z, y, x)
        a = self.positive_sorted
        i = int(np.searchsorted(a, key))
        return i < len(a) and a[i] == key

    def _gather_crops_3d(self, img_idx, zs, ys, xs) -> np.ndarray:
        """Raw (raw_size_z, raw_size, raw_size) windows centered at (z, y,
        x), zero outside the tomogram (memory_mapped_data.py:52-60)."""
        s, sz = self.raw_size, self.raw_size_z
        half, halfz = s // 2, sz // 2
        out = np.zeros((len(img_idx), sz, s, s), dtype=np.float32)
        for i, (k, z, y, x) in enumerate(zip(img_idx, zs, ys, xs)):
            vol = self.images[k]._mm
            D, H, W = vol.shape
            z0, y0, x0 = int(z) - halfz, int(y) - half, int(x) - half
            rz = slice(max(0, z0), min(D, z0 + sz))
            ry = slice(max(0, y0), min(H, y0 + s))
            rx = slice(max(0, x0), min(W, x0 + s))
            out[i, rz.start - z0:rz.stop - z0, ry.start - y0:ry.stop - y0,
                rx.start - x0:rx.stop - x0] = vol[rz, ry, rx]
        return out

    @staticmethod
    def _group_by_image(img_idx):
        """Yield (image index, stable-order selection) per distinct image."""
        order = np.argsort(img_idx, kind="stable")
        pos = 0
        while pos < len(order):
            k = img_idx[order[pos]]
            end = pos
            while end < len(order) and img_idx[order[end]] == k:
                end += 1
            yield k, order[pos:end]
            pos = end

    def _gather_crops(self, img_idx, ys, xs) -> np.ndarray:
        """Raw (raw_size^2) windows centered at (ys, xs)."""
        from topaz_tpu_torch.train.cropgather import gather_crops

        s = self.raw_size
        half = s // 2
        out = np.empty((len(img_idx), s, s), dtype=np.float32)
        for k, sel in self._group_by_image(img_idx):
            if self.native:
                out[sel] = gather_crops(np.asarray(self.images[k]._mm),
                                        ys[sel] - half, xs[sel] - half, s)
            else:
                for i in sel:
                    out[i] = self.images[k].crop(int(ys[i]) - half, int(xs[i]) - half, s, s)
        return out

    def _augmented_crops(self, img_idx, ys, xs) -> np.ndarray:
        """Rotated, flipped crops at the final size, in one pass (the 2D
        training path): the reference's oversized crop -> rotate -> center
        crop -> flip chain (memory_mapped_data.py:216-231), except that a
        corner pixel whose rotated source lies inside the image reads that
        pixel instead of the oversized crop's zero fill."""
        from topaz_tpu_torch.train.cropgather import gather_rotated_crops

        B = len(img_idx)
        size = self.crop_size
        angles = self.rng.uniform(0, 2 * np.pi, B)
        hflip = self.rng.random(B) < 0.5
        vflip = self.rng.random(B) < 0.5
        out = np.empty((B, size, size), dtype=np.float32)
        half = (size - 1) / 2.0

        for k, sel in self._group_by_image(img_idx):
            img = np.asarray(self.images[k]._mm)
            if self.native:
                out[sel] = gather_rotated_crops(img, ys[sel], xs[sel], angles[sel],
                                                hflip[sel], vflip[sel], size)
                continue
            H, W = img.shape
            vv, uu = np.mgrid[0:size, 0:size].astype(np.float64) - half
            for i in sel:
                v = -vv if vflip[i] else vv
                u = -uu if hflip[i] else uu
                c, s = np.cos(angles[i]), np.sin(angles[i])
                sy = np.rint(c * v + s * u + ys[i]).astype(np.int64)
                sx = np.rint(-s * v + c * u + xs[i]).astype(np.int64)
                valid = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
                out[i] = np.where(valid, img[np.clip(sy, 0, H - 1), np.clip(sx, 0, W - 1)], 0)
        return out

    def sample_positions(self, batch_size: int, n_pos: int):
        """(image index, z, y, x, labels) of a batch, the first n_pos
        positive, drawn as the JAX package's ``sample_batch`` draws them (z
        is 0 in 2D)."""
        n_neg = batch_size - n_pos
        # positives: uniform over expanded positive pixels
        if n_pos > 0:
            sel = self.rng.integers(0, self.num_pixels, size=n_pos)
            p_img, p_y, p_x = self.pos_img[sel], self.pos_y[sel], self.pos_x[sel]
            p_z = self.pos_z[sel]
        else:
            p_img = p_y = p_x = p_z = np.zeros(0, dtype=np.int64)

        # unlabeled / negative: random image, random pixel (rejecting exact
        # positives for the pn split)
        n_img = self.rng.integers(0, self.num_images, size=n_neg)
        n_y = np.empty(n_neg, dtype=np.int64)
        n_x = np.empty(n_neg, dtype=np.int64)
        n_z = np.zeros(n_neg, dtype=np.int64)
        for i, k in enumerate(n_img):
            H, W = self.images[k].shape[-2:]
            D = self.images[k].shape[0] if self.dims == 3 else 1
            while True:
                y = self.rng.integers(0, H)
                x = self.rng.integers(0, W)
                z = self.rng.integers(0, D) if self.dims == 3 else 0
                if self.positive_sorted is None or not self._is_positive(k, z, y, x):
                    break
            n_y[i], n_x[i], n_z[i] = y, x, z

        labels = np.zeros(batch_size, dtype=np.float32)
        labels[:n_pos] = 1.0
        return (np.concatenate([p_img, n_img]), np.concatenate([p_z, n_z]),
                np.concatenate([p_y, n_y]), np.concatenate([p_x, n_x]), labels)

    def sample_batch(self, batch_size: int, n_pos: int) -> Tuple[np.ndarray, np.ndarray]:
        """(crops, labels (B,)), the first n_pos positive. With 2D
        augmentation the crops come rotated and flipped at the final size,
        else as raw (B, raw_size, raw_size) windows, or (B, raw_size_z,
        raw_size, raw_size) in 3D."""
        img_idx, zs, ys, xs, labels = self.sample_positions(batch_size, n_pos)
        if self.dims == 3:
            crops = self._gather_crops_3d(img_idx, zs, ys, xs)
        elif self.augment:
            crops = self._augmented_crops(img_idx, ys, xs)
        else:
            crops = self._gather_crops(img_idx, ys, xs)
        return crops, labels


class ResidentVolumes:
    """A 3D sampler's tomograms on ``device``, each zero-padded by half a
    window on every side, so that the window the sampler's
    ``_gather_crops_3d`` cuts at (z, y, x) is the padded volume's slice
    starting at (z, y, x): ``gather`` cuts a batch of them on the device,
    equal to the host's."""

    def __init__(self, sampler: CropSampler, device):
        self.size, self.size_z = sampler.raw_size, sampler.raw_size_z
        pad = [(self.size_z // 2, self.size_z - 1 - self.size_z // 2)] + [
            (self.size // 2, self.size - 1 - self.size // 2)] * 2
        self.volumes = [torch.from_numpy(np.pad(np.asarray(im._mm, dtype=np.float32), pad))
                        .to(device) for im in sampler.images]

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.volumes)

    def gather(self, img_idx, zs, ys, xs) -> torch.Tensor:
        """(B, size_z, size, size) windows centered at the given voxels."""
        s, sz = self.size, self.size_z
        return torch.stack([self.volumes[k][z:z + sz, y:y + s, x:x + s]
                            for k, z, y, x in zip(img_idx.tolist(), zs.tolist(),
                                                  ys.tolist(), xs.tolist())])
