"""Dense picker scoring and U-Net denoising in plain ``torch.nn.functional``.

Weights come from a bundled ``.npz`` (keys ``params:<module>.<name>``,
kernels HWIO) and the layer list of the configuration file, so the
reference builds no module of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

LEAK = 0.1  # the denoiser's LeakyReLU slope (topaz/denoising/models.py)


def load_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of an ``.npz`` checkpoint's parameters, kernels
    turned from HWIO to OIHW, float32 on ``device``."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith("params:"):
                continue
            a = np.asarray(z[key], dtype=np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[key[len("params:"):]] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def receptive_field(layers: List[dict]) -> int:
    """Input extent that gives one output of the strided network
    (topaz/model/utils.py insize_from_outsize); a residual block counts as
    one layer of kernel 2 * dilation + 3."""
    size = 1
    for layer in reversed(layers):
        k = layer["k"] if layer["op"] == "conv" else 2 * layer["dilation"] + 3
        d = layer["dilation"] if layer["op"] == "conv" else 1
        size = (size - 1) * layer["stride"] + 1 + (k - 1) * d
    return size


def picker_scores(x: torch.Tensor, layers: List[dict], w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense ("filled") score map of (B, H, W) normalized micrographs, the
    input zero-padded by half the receptive field so the map has the
    input's shape. Every stride runs as 1 and multiplies the dilation of
    the layers after it (topaz/model/features/resnet.py fill())."""
    pad = receptive_field(layers) // 2
    h = F.pad(x[:, None], (pad, pad, pad, pad))
    acc = 1
    for i, layer in enumerate(layers):
        p = f"features.{i}."
        if layer["op"] == "conv":
            h = F.relu(F.conv2d(h, w[p + "conv_w"], w[p + "conv_b"],
                                dilation=layer["dilation"] * acc))
        else:
            d0, d1 = acc, layer["dilation"] * acc
            y = F.relu(F.conv2d(h, w[p + "conv0_w"], w[p + "conv0_b"], dilation=d0))
            y = F.conv2d(y, w[p + "conv1_w"], w[p + "conv1_b"], dilation=d1)
            e = d0 + d1
            skip = h[..., e:-e, e:-e]
            if p + "proj_w" in w:
                skip = F.conv2d(skip, w[p + "proj_w"])
            h = F.relu(y + skip)
        acc *= layer["stride"]
    return F.conv2d(h, w["classifier.w"], w["classifier.b"])[:, 0]


def _up(h: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize with the integer source index (j * n_in) // n_out."""
    for axis, n_out in ((-2, size[0]), (-1, size[1])):
        n_in = h.shape[axis]
        if n_in != n_out:
            idx = (torch.arange(n_out, device=h.device) * n_in) // n_out
            h = h.index_select(axis, idx)
    return h


def unet(x: torch.Tensor, w: Dict[str, torch.Tensor], levels: int = 5) -> torch.Tensor:
    """The U-Net of topaz/denoising/models.py (UDenoiseNet) on (B, 1, H, W):
    SAME convolutions, 2x max pools, nearest upsampling and skip concats."""
    def conv(h, name):
        k = w[name + ".w"].shape[-1]
        return F.conv2d(h, w[name + ".w"], w[name + ".b"], padding=k // 2)

    lrelu = lambda h: F.leaky_relu(h, LEAK)  # noqa: E731
    skips = [x]
    for i in range(1, levels + 1):
        skips.append(F.max_pool2d(lrelu(conv(skips[-1], f"enc{i}.0")), 2))
    h = lrelu(conv(skips.pop(), f"enc{levels + 1}.0"))
    for d in range(levels, 0, -1):
        skip = skips.pop()
        h = torch.cat([_up(h, skip.shape[2:]), skip], dim=1)
        if d > 1:
            h = lrelu(conv(lrelu(conv(h, f"dec{d}.0")), f"dec{d}.2"))
        else:
            h = conv(lrelu(conv(lrelu(conv(h, "dec1.0")), "dec1.2")), "dec1.4")
    return h


def std_pop(x: torch.Tensor) -> torch.Tensor:
    """Population standard deviation, accumulated in float64."""
    x64 = x.double()
    return torch.sqrt(torch.mean((x64 - x64.mean()) ** 2))


def denoise_whole(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """topaz/denoise.py's whole-image denoise of one (H, W) micrograph:
    standardize, denoise the standardized image with its own statistics
    (the model wrapper standardizes again), restore both scales."""
    mu, std = x.double().mean(), std_pop(x)
    z = ((x.double() - mu) / std).float()
    mu2, std2 = z.double().mean(), std_pop(z)
    y = unet(((z.double() - mu2) / std2).float()[None, None], w)[0, 0]
    return ((y.double() * std2 + mu2) * std + mu).float()
