"""Topaz-Denoise's 3D U-Net and its tomogram patch loop in plain
``torch.nn.functional``.

The model is ``UDenoiseNet3D`` (tbepler/topaz topaz/denoising/models.py:
452-564): five 2x max pools, ``nf`` features, a ``base_width``^3 first
convolution and 3^3 elsewhere, leaky ReLU 0.1; the decoder upsamples to the
skip's size by nearest neighbour and concatenates ``[up(h), skip]`` at
every level, the raw input at the top; the top block is (2nf + 1) -> 64 ->
32 -> 1 at ``top_width``^3. ``load_model`` builds the pretrained
``unet-3d-10a`` with ``base_width=7``. The patch loop is ``denoise3d``'s
(topaz/denoise.py:336-377, topaz/denoising/datasets.py:412-468): the
volume's mean and std; ceil(n / s) patches an axis, each a zero-filled
(s + 2p)^3 window around its s^3 tile, cut short at the volume's edge;
the window normalised by the volume's statistics, then standardised by
its own in the model wrapper, denoised, both scales restored; the tile's
centre kept.

Written from that description, with these departures:

* The upsample takes the integer source index ``(j * n_in) // n_out`` on
  each axis. The published code calls ``F.interpolate(mode="nearest")``,
  which computes a float scale and picks another source plane for some odd
  sizes; at even sizes (every level of a 192^3 patch) the two agree.
* Weights come from a seeded ``.npz`` in the JAX layout (kernels DHWIO,
  keys ``params:<module>.<index>.w``), turned into OIDHW here; the
  published model loads a pickled ``.sav``.
* Every statistic is taken in float64 (the published code: numpy's and
  torch's float32 sums); the network runs in float32, TF32 off unless a
  caller asks for it (the control).
* Patches are cut from a copy of the volume on the volume's device, one
  patch a forward (``denoise3d``'s default ``-b 1``), not by a host
  ``DataLoader``: the same values.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

LEAK = 0.1


def layers(nf: int, base_width: int, top_width: int, levels: int = 5) -> List[dict]:
    """The network's convolutions in order, each with its kernel, channels
    and the pooling level it runs at (a level-l map has 8^-l of the input's
    voxels)."""
    out = [{"name": "enc1.0", "k": base_width, "cin": 1, "cout": nf, "level": 0}]
    for i in range(2, levels + 2):
        out.append({"name": f"enc{i}.0", "k": 3, "cin": nf, "cout": nf, "level": i - 1})
    for d in range(levels, 1, -1):
        cin = 2 * nf if d == levels else 3 * nf
        out.append({"name": f"dec{d}.0", "k": 3, "cin": cin, "cout": 2 * nf, "level": d - 1})
        out.append({"name": f"dec{d}.2", "k": 3, "cin": 2 * nf, "cout": 2 * nf, "level": d - 1})
    for name, cin, cout in (("dec1.0", 2 * nf + 1, 64), ("dec1.2", 64, 32), ("dec1.4", 32, 1)):
        out.append({"name": name, "k": top_width, "cin": cin, "cout": cout, "level": 0})
    return out


def load_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """``{"<module>.<index>.w" | ".b": tensor}`` of an ``.npz`` checkpoint,
    kernels turned from DHWIO to OIDHW, float32 on ``device``."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith("params:"):
                continue
            a = np.asarray(z[key], dtype=np.float32)
            if a.ndim == 5:
                a = a.transpose(4, 3, 0, 1, 2)
            out[key[len("params:"):]] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def _up(h: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of the last three axes with the integer source index."""
    for axis, n_out in zip((-3, -2, -1), size):
        n_in = h.shape[axis]
        if n_in != n_out:
            h = h.index_select(axis, (torch.arange(n_out, device=h.device) * n_in) // n_out)
    return h


def unet3d(x: torch.Tensor, w: Dict[str, torch.Tensor], levels: int = 5) -> torch.Tensor:
    """UDenoiseNet3D on (N, 1, D, H, W): SAME convolutions, 2x max pools
    (odd sizes floor), nearest upsampling and skip concats."""
    def conv(h, name):
        k = w[name + ".w"].shape[-1]
        return F.conv3d(h, w[name + ".w"], w[name + ".b"], padding=k // 2)

    lrelu = lambda h: F.leaky_relu(h, LEAK)  # noqa: E731
    skips = [x]
    for i in range(1, levels + 1):
        skips.append(F.max_pool3d(lrelu(conv(skips[-1], f"enc{i}.0")), 2))
    h = lrelu(conv(skips.pop(), f"enc{levels + 1}.0"))
    for d in range(levels, 0, -1):
        skip = skips.pop()
        h = torch.cat([_up(h, skip.shape[2:]), skip], dim=1)
        if d > 1:
            h = lrelu(conv(lrelu(conv(h, f"dec{d}.0")), f"dec{d}.2"))
        else:
            h = conv(lrelu(conv(lrelu(conv(h, "dec1.0")), "dec1.2")), "dec1.4")
    return h


def _mean_std(x: torch.Tensor):
    """Mean and population std, in float64."""
    x64 = x.double()
    mu = x64.mean()
    return mu, torch.sqrt(torch.mean((x64 - mu) ** 2))


def denoise_patches(tomo: torch.Tensor, w: Dict[str, torch.Tensor], patch_size: int,
                    padding: int, tf32: bool = False) -> torch.Tensor:
    """``denoise3d -s patch_size -p padding`` of one (D, H, W) float32
    volume, on its device; float32 out."""
    s, p = int(patch_size), int(padding)
    d = s + 2 * p
    mu, std = _mean_std(tomo)
    out = torch.empty_like(tomo)
    shape = tomo.shape
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
        for i in range(0, shape[0], s):
            for j in range(0, shape[1], s):
                for k in range(0, shape[2], s):
                    origin = (i, j, k)
                    lo = [max(0, c - p) for c in origin]
                    hi = [min(n, c + s + p) for c, n in zip(origin, shape)]
                    x = torch.zeros((d, d, d), dtype=torch.float32, device=tomo.device)
                    x[tuple(slice(p - c + a, p - c + b) for c, a, b in zip(origin, lo, hi))] = \
                        tomo[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
                    xn = (x.double() - mu) / std
                    m, sd = _mean_std(xn)
                    y = unet3d(((xn - m) / sd).float()[None, None], w)[0, 0]
                    y = (y.double() * sd + m) * std + mu
                    end = [min(n, c + s) for c, n in zip(origin, shape)]
                    out[i:end[0], j:end[1], k:end[2]] = \
                        y[p:p + end[0] - i, p:p + end[1] - j, p:p + end[2] - k].float()
    return out
