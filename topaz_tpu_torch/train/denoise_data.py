"""Noise2noise training data: paired micrographs and even/odd tomogram tiles
(port of topaz_tpu/train/denoise_data.py).

Host-side batched samplers with the semantics of
topaz/denoising/datasets.py: per-image standardization with optional pixel
cutoff, random crops, flip/rot90/pair-swap augmentation (2D), cryoCARE-style
non-overlapping train/validation tile sampling for tomograms (3D). Host
numpy throughout, making the JAX package's generator calls in its order, so
that a seed gives the same crops and tiles bit for bit. h5py is imported
only by ``make_hdf5_samplers``.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import List

import numpy as np

from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.io.image import load_image


def _standardize(x: np.ndarray, cutoff: float = 0) -> np.ndarray:
    x = x.astype(np.float32)
    x = (x - x.mean()) / x.std()
    if cutoff > 0:
        x[(x < -cutoff) | (x > cutoff)] = 0
    return x


class PairedImagesSampler:
    """Random paired crops with flip/rot90/swap augmentation
    (datasets.py:32-100)."""

    def __init__(self, paths_a: List[str], paths_b: List[str], crop: int = 800,
                 xform: bool = True, cutoff: float = 0, seed: int = 0):
        self.paths_a = paths_a
        self.paths_b = paths_b
        self.crop = crop
        self.xform = xform
        self.cutoff = cutoff
        self.rng = np.random.default_rng(seed)
        self._cache = {}

    def __len__(self):
        return len(self.paths_a)

    def _load(self, path):
        if path not in self._cache:
            self._cache[path] = _standardize(np.asarray(load_image(path)),
                                             self.cutoff)
        return self._cache[path]

    def _item(self, i):
        x = self._load(self.paths_a[i])
        y = self._load(self.paths_b[i])
        if self.crop is not None:
            size = min(self.crop, x.shape[0], x.shape[1])
            r0 = self.rng.integers(0, x.shape[0] - size + 1)
            c0 = self.rng.integers(0, x.shape[1] - size + 1)
            x = x[r0 : r0 + size, c0 : c0 + size]
            y = y[r0 : r0 + size, c0 : c0 + size]
        if self.xform:
            if self.rng.random() > 0.5:
                x, y = np.flip(x, 0), np.flip(y, 0)
            if self.rng.random() > 0.5:
                x, y = np.flip(x, 1), np.flip(y, 1)
            k = self.rng.integers(0, 4)
            x, y = np.rot90(x, k=k), np.rot90(y, k=k)
            if self.rng.random() > 0.5:
                x, y = y, x
        return np.ascontiguousarray(x), np.ascontiguousarray(y)

    def batches(self, batch_size: int, shuffle: bool = True):
        order = (self.rng.permutation(len(self)) if shuffle
                 else np.arange(len(self)))
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            pairs = [self._item(i) for i in idx]
            xs = np.stack([p[0] for p in pairs])
            ys = np.stack([p[1] for p in pairs])
            yield xs, ys


def make_paired_images_samplers(dir_a: str, dir_b: str, crop: int = 800,
                                holdout: float = 0.1, cutoff: float = 0,
                                seed: int = 0):
    """Split A/B-paired micrographs into train/validation samplers
    (datasets.py:472-503)."""
    A, B = [], []
    for path in sorted(glob.glob(os.path.join(dir_a, "*.mrc"))):
        name = os.path.basename(path)
        A.append(path)
        B.append(os.path.join(dir_b, name))

    rng = np.random.default_rng(seed)
    n = int(holdout * len(A))
    order = rng.permutation(len(A))
    val_idx, train_idx = order[:n], order[n:]
    print("# training with", len(train_idx), "image pairs", file=sys.stderr)
    print("# validating on", len(val_idx), "image pairs", file=sys.stderr)
    train = PairedImagesSampler([A[i] for i in train_idx], [B[i] for i in train_idx],
                                crop=crop, xform=True, cutoff=cutoff, seed=seed)
    val = PairedImagesSampler([A[i] for i in val_idx], [B[i] for i in val_idx],
                              crop=crop, xform=False, cutoff=cutoff, seed=seed + 1)
    return train, val


def make_hdf5_samplers(path: str, holdout: float = 0.1, cutoff: float = 0,
                       seed: int = 0):
    """Paired image stack from an HDF5 file (datasets.py:506-529): images
    alternate source/target. (The reference's HDFPairedDataset pairs each
    image with itself and references unset state — datasets.py:107,117-118 —
    a bug we do not replicate.)"""
    import h5py

    f = h5py.File(path, "r")
    data = f["images"]
    N = len(data) // 2
    n = int(holdout * N)
    split = 2 * (N - n)

    class _HdfSampler(PairedImagesSampler):
        def __init__(self, start, end, xform):
            super().__init__([], [], crop=None, xform=xform, cutoff=cutoff,
                             seed=seed)
            self.start, self.end = start, end

        def __len__(self):
            return (self.end - self.start) // 2

        def _item(self, i):
            x = _standardize(np.asarray(data[self.start + 2 * i]), self.cutoff)
            y = _standardize(np.asarray(data[self.start + 2 * i + 1]), self.cutoff)
            if self.xform:
                if self.rng.random() > 0.5:
                    x, y = np.flip(x, 0), np.flip(y, 0)
                if self.rng.random() > 0.5:
                    x, y = np.flip(x, 1), np.flip(y, 1)
                k = self.rng.integers(0, 4)
                x, y = np.rot90(x, k=k), np.rot90(y, k=k)
                if self.rng.random() > 0.5:
                    x, y = y, x
            return np.ascontiguousarray(x), np.ascontiguousarray(y)

    train = _HdfSampler(0, split, True)
    val = _HdfSampler(split, 2 * N, False)
    print("# training with", len(train), "image pairs", file=sys.stderr)
    print("# validating on", len(val), "image pairs", file=sys.stderr)
    return train, val


class PairedTiles3D:
    """Even/odd tomogram tile pairs with 3-axis flip/rot augmentation
    (TrainingDataset3D, datasets.py:150-397). Train and test tiles are
    sampled from disjoint regions (cryoCARE protocol)."""

    def __init__(self, even_path: str, odd_path: str, tilesize: int,
                 n_train: int, n_test: int, seed: int = 0):
        if tilesize < 1:
            raise ValueError("tilesize must be > 0")
        if tilesize < 10:
            print("WARNING: small tilesize is not recommended", file=sys.stderr)
        self.tilesize = tilesize
        self.rng = np.random.default_rng(seed)

        even_paths, odd_paths = [], []
        if os.path.isfile(even_path) and os.path.isfile(odd_path):
            even_paths, odd_paths = [even_path], [odd_path]
        elif os.path.isdir(even_path) and os.path.isdir(odd_path):
            for epath in sorted(glob.glob(os.path.join(even_path, "*"))):
                name = os.path.basename(epath)
                opath = os.path.join(odd_path, name)
                if os.path.isfile(opath):
                    even_paths.append(epath)
                    odd_paths.append(opath)
                else:
                    print("# Error: name mismatch between even and odd "
                          "directory,", name, file=sys.stderr)

        self.volumes = []  # (even, odd, means, stds)
        self.train_tiles = []  # (vol_idx, slices)
        self.test_tiles = []
        for epath, opath in zip(even_paths, odd_paths):
            even, _, _ = mrc.read(epath)
            odd, _, _ = mrc.read(opath)
            even = even.astype(np.float32)
            odd = odd.astype(np.float32)
            if even.shape != odd.shape:
                print("# Error: shape mismatch:", epath, opath, file=sys.stderr)
                continue
            vi = len(self.volumes)
            self.volumes.append(
                (even, odd, (even.mean(), odd.mean()), (even.std(), odd.std()))
            )
            tr, te = self._sample_coordinates(even.shape, n_train, n_test)
            self.train_tiles += [(vi, s) for s in tr]
            self.test_tiles += [(vi, s) for s in te]

        if not self.volumes:
            raise ValueError("need at least 1 even/odd volume pair")
        if not self.train_tiles:
            raise ValueError(
                f"no training tiles could be sampled with --crop {tilesize}: "
                "every volume must be strictly larger than the crop in all "
                "three dimensions "
                f"(volume shapes: {[v[0].shape for v in self.volumes]})")

    def _sample_coordinates(self, shape, n_train, n_test):
        """cryoCARE-style disjoint train/val center sampling
        (datasets.py:254-333)."""
        t = self.tilesize
        span_half = np.round(np.array(shape) * 0.1 / 2).astype(int)
        tv = np.array([t // 2] * 3)
        tv_hi = np.array([t - t // 2] * 3)  # odd tilesizes are asymmetric

        mask = np.ones(shape, dtype=np.uint8)
        for d in range(3):
            sl = [slice(None)] * 3
            sl[d] = slice(0, tv[d])
            mask[tuple(sl)] = 0
            sl[d] = slice(shape[d] - tv_hi[d], shape[d])
            mask[tuple(sl)] = 0

        val_mask = mask.copy()
        for d in (1, 2):
            sl = [slice(None)] * 3
            sl[d] = slice(0, span_half[d])
            val_mask[tuple(sl)] = 0
            sl[d] = slice(shape[d] - span_half[d], shape[d])
            val_mask[tuple(sl)] = 0

        fg = np.flatnonzero(val_mask)
        picks = self.rng.choice(len(fg), size=min(2, len(fg)), replace=False)
        centers = np.unravel_index(fg[picks], shape)

        val_region = np.zeros(shape, dtype=np.uint8)
        for z, y, x in zip(*centers):
            sl = tuple(slice(max(0, c - s), c + s)
                       for c, s in zip((z, y, x), span_half))
            val_region[sl] = mask[sl]
            ex = tuple(slice(max(0, c - s - tv_), min(n, c + s + tv_))
                       for c, s, tv_, n in zip((z, y, x), span_half, tv, shape))
            mask[ex] = 0

        def draw(m, count):
            fg = np.flatnonzero(m)
            if len(fg) == 0:
                return []
            sel = self.rng.choice(len(fg), size=count, replace=count > len(fg))
            zyx = np.unravel_index(fg[sel], shape)
            # slice is exactly tilesize long (c - t//2, c - t//2 + t):
            # the symmetric form silently produced (t-1)-tiles for odd t
            return [tuple(slice(c - tv_, c - tv_ + t) for c, tv_ in zip(cs, tv))
                    for cs in zip(*zyx)]

        return draw(mask, n_train), draw(val_region, n_test)

    def _augment(self, x, y):
        for ax in range(3):
            if self.rng.random() < 0.5:
                x, y = np.flip(x, ax), np.flip(y, ax)
        for axes in ((0, 1), (0, 2), (1, 2)):
            k = self.rng.integers(0, 4)
            x, y = np.rot90(x, k=k, axes=axes), np.rot90(y, k=k, axes=axes)
        return np.ascontiguousarray(x), np.ascontiguousarray(y)

    def _materialize(self, tiles, augment):
        xs, ys = [], []
        for vi, sl in tiles:
            even, odd, means, stds = self.volumes[vi]
            x = (even[sl] - means[0]) / stds[0]
            y = (odd[sl] - means[1]) / stds[1]
            if augment:
                x, y = self._augment(x, y)
            xs.append(x)
            ys.append(y)
        return xs, ys

    def batches(self, batch_size: int, mode: str = "train", shuffle: bool = True):
        tiles = self.train_tiles if mode == "train" else self.test_tiles
        order = (self.rng.permutation(len(tiles)) if shuffle
                 else np.arange(len(tiles)))
        for start in range(0, len(order), batch_size):
            sel = [tiles[i] for i in order[start : start + batch_size]]
            xs, ys = self._materialize(sel, augment=(mode == "train"))
            yield np.stack(xs), np.stack(ys)
