"""Seeded inputs: CTF micrographs made on the device, MRC files, and a
seeded sample of a stream of outputs.

Every draw comes from ``--seed`` through a named stream, so one seed gives
the same inputs on every run. Sizes and counts are fixed by the traffic
file; a seed only moves particles, defocus order and the order of files.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MRC_HEADER = 1024


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the named stream of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def host_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, name))


def device_generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))


def micrograph(shape: Tuple[int, int], defocus_a: float, p: dict, gen: torch.Generator,
               device) -> torch.Tensor:
    """One (H, W) float32 micrograph on ``device``: solid-sphere particle
    projections on a jittered grid, through a CTF with a B-factor envelope,
    over white shot noise and 1/f ice noise (the contrast and spectrum of a
    300 kV exposure; parameters in the traffic file's ``micrograph``)."""
    H, W = shape
    r = float(p["particle_radius_px"])
    sep = p["min_sep"] * r
    cell = 1.25 * sep
    margin = r + 32
    ny, nx = int((H - 2 * margin) // cell), int((W - 2 * margin) // cell)
    n = int(round(p["occupancy"] * ny * nx))
    slots = torch.randperm(ny * nx, generator=gen, device=device)[:n]
    jitter = (torch.rand((n, 2), generator=gen, device=device) - 0.5) * (cell - sep)
    cy = (margin + (slots // nx).float() * cell + cell / 2 + jitter[:, 0]).long()
    cx = (margin + (slots % nx).float() * cell + cell / 2 + jitter[:, 1]).long()
    delta = torch.zeros((H, W), device=device)
    delta[cy, cx] = 1.0
    # the sphere's projection centred on pixel (0, 0) of the periodic grid
    dy = torch.minimum(torch.arange(H, device=device), H - torch.arange(H, device=device)).float()
    dx = torch.minimum(torch.arange(W, device=device), W - torch.arange(W, device=device)).float()
    d2 = dy[:, None] ** 2 + dx[None, :] ** 2
    sphere = torch.sqrt(torch.clamp(r * r - d2, min=0.0)) / r
    fy = torch.fft.fftfreq(H, d=p["pixel_a"], device=device)[:, None]
    fx = torch.fft.rfftfreq(W, d=p["pixel_a"], device=device)[None, :]
    f2 = fy ** 2 + fx ** 2
    lam, cs, amp = p["wavelength_a"], p["cs_a"], p["amplitude_contrast"]
    chi = math.pi * lam * defocus_a * f2 - 0.5 * math.pi * cs * lam ** 3 * f2 ** 2
    ctf = ((math.sqrt(1 - amp ** 2) * torch.sin(chi) + amp * torch.cos(chi))
           * torch.exp(-p["bfactor_a2"] * f2 / 4.0))
    signal = torch.fft.irfft2(-torch.fft.rfft2(delta) * torch.fft.rfft2(sphere) * ctf, s=(H, W))
    white = torch.randn((H, W), generator=gen, device=device)
    pink = torch.fft.irfft2(
        torch.fft.rfft2(torch.randn((H, W), generator=gen, device=device))
        / torch.sqrt(torch.clamp(torch.sqrt(f2) / 0.002, min=1.0)), s=(H, W))
    pink = pink / pink.std()
    return (p["signal"] * signal + p["white"] * white + p["pink"] * pink).float()


def micrograph_set(cameras: Sequence[dict], p: dict, seed: int, device) -> List[Tuple[str, torch.Tensor]]:
    """The distinct micrographs of a traffic mix, ``files`` of each camera,
    as (name, (H, W) tensor on ``device``). Each camera's defocus values are
    evenly spaced over the traffic's range, dealt out in a seeded order."""
    gen = device_generator(seed, "micrographs", device)
    rng = host_rng(seed, "defocus")
    lo, hi = p["defocus_a"]
    out = []
    for cam in cameras:
        k = int(cam["files"])
        defocus = lo + (hi - lo) * (np.arange(k) + 0.5) / k
        for i, d in enumerate(rng.permutation(defocus)):
            out.append((f"{cam['name']}_{i:02d}", micrograph(tuple(cam["shape"]), float(d), p, gen,
                                                             device)))
    return out


def write_mrc(path: str, image: np.ndarray) -> None:
    """A mode-2 (float32) MRC2014 file of one (H, W) image."""
    image = np.ascontiguousarray(image, dtype="<f4")
    H, W = image.shape
    header = np.zeros(256, dtype="<i4")
    header[0:3] = (W, H, 1)             # nx, ny, nz
    header[3] = 2                       # mode: float32
    header[7:10] = (W, H, 1)            # mx, my, mz
    header[10:13] = np.array([W, H, 1], dtype="<f4").view("<i4")  # cell (A)
    header[13:16] = np.array([90, 90, 90], dtype="<f4").view("<i4")
    header[16:19] = (1, 2, 3)           # mapc, mapr, maps
    header[19:22] = np.array([image.min(), image.max(), image.mean()], dtype="<f4").view("<i4")
    header[27] = 20140                  # nversion, at byte 108
    raw = bytearray(header.tobytes())
    raw[208:212] = b"MAP "
    raw[212:216] = bytes([0x44, 0x44, 0, 0])  # little-endian stamp
    raw[216:220] = np.array([image.std()], dtype="<f4").tobytes()
    with open(path, "wb") as f:
        f.write(bytes(raw))
        f.write(image.tobytes())
        # on the disk before the window opens, so that no write-back of
        # set-up's files runs inside it
        f.flush()
        os.fsync(f.fileno())


def read_mrc(path: str) -> np.ndarray:
    """The (H, W) float32 image of a mode-2 MRC file."""
    with open(path, "rb") as f:
        raw = f.read()
    nx, ny, nz, mode = np.frombuffer(raw[:16], dtype="<i4")
    nsymbt = int(np.frombuffer(raw[92:96], dtype="<i4")[0])
    if mode != 2 or nz != 1:
        raise ValueError(f"{path}: expected one float32 image, got mode {mode}, nz {nz}")
    return np.frombuffer(raw, dtype="<f4", offset=MRC_HEADER + nsymbt,
                         count=int(nx) * int(ny)).reshape(int(ny), int(nx))


def write_set(images: Sequence[Tuple[str, torch.Tensor]], directory: str) -> List[str]:
    """Each image as ``<directory>/<name>.mrc``; returns the paths."""
    paths = []
    for name, image in images:
        path = os.path.join(directory, name + ".mrc")
        write_mrc(path, image.cpu().numpy())
        paths.append(path)
    return paths


def write_inputs(traffic: dict, seed: int, device, workdir: str) -> Dict[str, List[str]]:
    """The traffic's micrographs as MRC files in ``workdir``: {camera: paths}."""
    images = micrograph_set(traffic["cameras"], traffic["micrograph"], seed, device)
    paths = write_set(images, workdir)
    by_camera: Dict[str, List[str]] = {}
    for (name, _), path in zip(images, paths):
        by_camera.setdefault(name.rsplit("_", 1)[0], []).append(path)
    return by_camera


class Reservoir:
    """A seeded uniform sample of at most ``k`` items of a stream."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make):
        """Offer the next item; ``make()`` builds it only if it is kept."""
        if self.seen < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = make()
        self.seen += 1
