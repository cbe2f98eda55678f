"""Noise2noise denoiser architectures in 2D and 3D (port of
topaz_tpu/models/denoise.py, the reference's topaz/denoising/models.py).

  * UDenoiseNet       ``unet`` (5 levels), and ``unet3`` with
                      ``residual=True``: it predicts the noise, y = x - f(x)
  * UDenoiseNetSmall  ``unet-small`` (3 levels)
  * UDenoiseNet2      ``unet2``: no skip concat on the top two levels
  * DenoiseNet2       ``fcnet``: three wide convolutions
  * AffineDenoise     ``affine``: one 31x31 convolution

Every module takes ``dims`` (2 or 3): layout NCHW with OIHW kernels, or
NCDHW with OIDHW kernels (``nn.Conv3d``, ``nn.MaxPool3d``). Module and
parameter names follow the reference's ``nn.Sequential`` layout
(``enc1.0.weight``, ``dec1.4.bias``, ``net.2.weight``, ``filter.weight``),
which is also the key layout of the JAX package's parameter trees, so
weights carry across by name. Every convolution is SAME with an odd kernel,
i.e. zero padding k//2 on each side; pooling is a VALID 2x max (odd sizes
floor); the decoder is the plain form: nearest upsample with the integer
source-index rule on every spatial axis, concatenate ``[up(h), skip]`` on
the channel axis, convolve. The 3D U-Net's one-channel convolutions (its
first and last) run as ``TapConv3d`` where they fit.

Where no autograd graph is needed and input and weights are float32 on a
card, ``UDenoiseNet`` runs each convolution without its bias and each edge
to the next convolution as one hand-written pass (``ops/unet_edges``: bias
and leaky ReLU, then the pool or the upsample into the concat), the same
float operations in the same order, so the same bits; anything else runs
the modules. ``fused_forwards`` and ``plain_forwards`` count the two routes.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from topaz_tpu_torch.ops import unet_edges as edges
from topaz_tpu_torch.ops.unet_edges import LEAK, up_nearest

# UDenoiseNet forwards on the fused route and on the modules' route in this
# process; callers may reset each to 0
fused_forwards = 0
plain_forwards = 0
_lock = threading.Lock()  # the counters, from a mesh's threads too


_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_POOL = {2: nn.MaxPool2d, 3: nn.MaxPool3d}


def _conv(cin: int, cout: int, k: int, dims: int = 2, taps: bool = False) -> nn.Module:
    if k % 2 != 1:
        raise ValueError(f"denoiser kernels are odd-sized, got {k}")
    return (TapConv3d if taps else _CONV[dims])(cin, cout, k, padding=k // 2)


class TapConv3d(nn.Conv3d):
    """A SAME 3D convolution with one input or one output channel, run as
    taps because cuDNN runs these far below its rate on the other layers
    (H100, f32, one 192^3 window of the 3D U-Net: the 1 -> 48 7^3 layer
    17.98 ms, 12.8 TFLOP/s; the 32 -> 1 3^3 layer 13.13 ms, 0.92 TFLOP/s, 47x
    its memory bound). One input channel: the k^2 (z, y) shifts of the input
    stacked as channels and convolved along x (10.23 ms, the same bits on
    that card). One output channel: every channel's k^3 taps in one matrix
    product and the shifted taps summed (2.58 ms, the sum in another order).
    Autograd runs through both, faster than cuDNN's backward (10 x 96^3,
    forward and backward: the 7^3 layer 43.7 ms in place of 573, the 32 -> 1
    layer 73.7 in place of 92.6)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int):
        if 1 not in (in_channels, out_channels) or padding != kernel_size // 2:
            raise ValueError(f"TapConv3d is a SAME convolution with one input or output channel, "
                             f"got {in_channels} -> {out_channels}, kernel {kernel_size}, "
                             f"padding {padding}")
        super().__init__(in_channels, out_channels, kernel_size, padding=padding)

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
        # nn.Conv3d.forward's hook, so that the fused route can run either
        # form without its bias
        k = self.kernel_size[0]
        p = k // 2
        N, _, D, H, W = x.shape
        if self.in_channels == 1:
            xp = F.pad(x, (0, 0, p, p, p, p))
            shifts = torch.cat([xp[:, :, dz:dz + D, dy:dy + H] for dz in range(k)
                                for dy in range(k)], dim=1)
            return F.conv3d(shifts, weight.reshape(self.out_channels, k * k, 1, 1, k),
                            bias, padding=(0, 0, p))
        taps = weight[0].permute(1, 2, 3, 0).reshape(1, k ** 3, self.in_channels)
        # bmm: the same product through matmul (a matrix times a batch) made
        # this layer 7.1 ms in place of 2.6 (H100, a 192^3 window)
        t = F.pad(torch.bmm(taps.expand(N, -1, -1), x.reshape(N, self.in_channels, -1)).reshape(
            N, k ** 3, D, H, W), (p,) * 6)
        y = t[:, :1, :D, :H, :W].clone() if bias is None else (
            bias.reshape(1, 1, 1, 1, 1) + t[:, :1, :D, :H, :W])
        for o, (dz, dy, dx) in enumerate(itertools.product(range(k), repeat=3)):
            if o:
                y += t[:, o:o + 1, dz:dz + D, dy:dy + H, dx:dx + W]
        return y


def _lrelu() -> nn.LeakyReLU:
    return nn.LeakyReLU(LEAK)


def _up_cat(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    return torch.cat([up_nearest(h, skip.shape[2:]), skip], dim=1)


def _unbiased(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv``'s output before its bias: on a card the same cuDNN call,
    whose bias PyTorch adds afterwards as a pass of its own."""
    return conv._conv_forward(x, conv.weight, None)


def fused_route(x: torch.Tensor, params) -> bool:
    """Whether a U-Net forward on ``x`` with parameters ``params`` runs on
    the fused route: ``x`` a float32 CUDA tensor, every parameter float32 in
    the standard layout (so cuDNN's outputs are too), and no autograd graph
    to build (gradients off, or nothing that requires one)."""
    if not (x.is_cuda and x.dtype == torch.float32):
        return False
    if not all(p.dtype == torch.float32 and p.is_contiguous() for p in params):
        return False
    return not (torch.is_grad_enabled()
                and (x.requires_grad or any(p.requires_grad for p in params)))


class UDenoiseNet(nn.Module):
    """U-Net with ``levels`` 2x pooling levels; each decoder level
    upsamples and concatenates the encoder map of its level, or the input
    at the top, unless the level is in ``skipless`` (reference
    models.py:74-175)."""

    levels = 5
    skipless = ()

    def __init__(self, nf: int = 48, base_width: int = 11, top_width: int = 3,
                 residual: bool = False, dims: int = 2):
        super().__init__()
        self.residual = residual
        L = self.levels
        conv = lambda cin, cout, k: _conv(cin, cout, k, dims)  # noqa: E731
        pool = _POOL[dims]
        # in 3D the one-channel first and last layers run as taps where the
        # taps are no wider than the top level's concat, the widest map the
        # network holds at full size anyway
        top_in = 2 * nf + (1 not in self.skipless)
        self.enc1 = nn.Sequential(
            _conv(1, nf, base_width, dims, taps=dims == 3 and base_width ** 2 <= top_in),
            _lrelu(), pool(2))
        for i in range(2, L + 1):
            setattr(self, f"enc{i}", nn.Sequential(conv(nf, nf, 3), _lrelu(), pool(2)))
        setattr(self, f"enc{L + 1}", nn.Sequential(conv(nf, nf, 3), _lrelu()))
        for d in range(L, 1, -1):
            cin = 2 * nf if d == L or d in self.skipless else 3 * nf
            setattr(self, f"dec{d}", nn.Sequential(
                conv(cin, 2 * nf, 3), _lrelu(), conv(2 * nf, 2 * nf, 3), _lrelu()))
        self.dec1 = nn.Sequential(
            conv(top_in, 64, top_width), _lrelu(), conv(64, 32, top_width), _lrelu(),
            _conv(32, 1, top_width, dims, taps=dims == 3 and top_width ** 3 <= top_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 1, *spatial) -> (N, 1, *spatial)."""
        fused = fused_route(x, list(self.parameters()))
        global fused_forwards, plain_forwards
        with _lock:
            if fused:
                fused_forwards += 1
            else:
                plain_forwards += 1
        return self._fused(x) if fused else self._plain(x)

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        """The forward through the modules."""
        L = self.levels
        skips = [x]
        for i in range(1, L + 1):
            skips.append(getattr(self, f"enc{i}")(skips[-1]))
        h = getattr(self, f"enc{L + 1}")(skips.pop())
        for d in range(L, 0, -1):
            skip = skips.pop()
            h = up_nearest(h, skip.shape[2:]) if d in self.skipless else _up_cat(h, skip)
            h = getattr(self, f"dec{d}")(h)
        return x - h if self.residual else h

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """The forward with each convolution run without its bias and each
        edge to the next convolution one pass of ``ops/unet_edges``: the
        bias and leaky ReLU, then the pool, or the upsample into the concat
        with the skip, or nothing; the 3D U-Net's last layer (taps) as its
        module. The modules' bits, on a card."""
        L = self.levels
        x = x.contiguous()
        skips = [x]
        for i in range(1, L + 1):
            conv = getattr(self, f"enc{i}")[0]
            skips.append(edges.bias_lrelu_pool(_unbiased(conv, skips[-1]), conv.bias))
        conv = getattr(self, f"enc{L + 1}")[0]
        h, bias = _unbiased(conv, skips.pop()), conv.bias
        for d in range(L, 0, -1):
            skip = skips.pop()
            h = edges.bias_lrelu_up_cat(h, bias, None if d in self.skipless else skip,
                                        skip.shape[2:])
            dec = getattr(self, f"dec{d}")
            h = edges.bias_lrelu_(_unbiased(dec[0], h), dec[0].bias)
            h, bias = _unbiased(dec[2], h), dec[2].bias
        h = edges.bias_lrelu_(h, bias)
        last = self.dec1[4]
        if isinstance(last, TapConv3d):
            h = last(h)
        else:
            h = edges.bias_lrelu_(_unbiased(last, h), last.bias, leaky=False)
        return x - h if self.residual else h


class UDenoiseNetSmall(UDenoiseNet):
    """Three-level U-Net (reference models.py:178-244)."""

    levels = 3


class UDenoiseNet2(UDenoiseNet):
    """Five-level U-Net whose top two decoder levels upsample without a
    skip concat (reference models.py:247-346)."""

    skipless = (2, 1)


class DenoiseNet2(nn.Module):
    """``fcnet``: conv -> lrelu -> conv -> lrelu -> conv, all
    ``base_width`` wide (reference models.py:52-66)."""

    def __init__(self, nf: int = 48, base_width: int = 11, dims: int = 2):
        super().__init__()
        self.net = nn.Sequential(
            _conv(1, nf, base_width, dims), _lrelu(), _conv(nf, nf, base_width, dims),
            _lrelu(), _conv(nf, 1, base_width, dims))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class AffineDenoise(nn.Module):
    """One learnable 31-wide convolution (reference topaz/filters.py:40-48)."""

    def __init__(self, width: int = 31, dims: int = 2):
        super().__init__()
        self.filter = _conv(1, 1, width, dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.filter(x)


def make_denoiser(meta: Dict) -> nn.Module:
    """An uninitialised module for a checkpoint's meta dict (arch, nf,
    base_width, top_width, dims)."""
    arch, dims = meta["arch"], meta.get("dims", 2)
    if dims not in _CONV:
        raise ValueError(f"denoisers are 2D or 3D, got dims={dims}")
    nf, bw, tw = meta.get("nf", 48), meta.get("base_width", 11), meta.get("top_width", 3)
    if arch in ("unet", "unet3"):
        return UDenoiseNet(nf, bw, tw, residual=arch == "unet3", dims=dims)
    if arch == "unet-small":
        return UDenoiseNetSmall(nf, bw, tw, dims=dims)
    if arch == "unet2":
        return UDenoiseNet2(nf, bw, tw, dims=dims)
    if arch == "fcnet":
        return DenoiseNet2(nf, bw, dims=dims)
    if arch == "affine":
        return AffineDenoise(dims=dims)
    raise ValueError(f"unknown denoiser arch: {arch}")


@torch.no_grad()
def init_denoiser(meta: Dict, generator: torch.Generator) -> nn.Module:
    """A module for ``meta`` initialised at the JAX package's scales
    (topaz_tpu/models/denoise.py:408-433): every weight and bias uniform in
    +-1/sqrt(cin * k^dims), drawn from ``generator`` (a CPU generator) in
    the layout's order, weight then bias; the affine model all zeros. The
    draws are not JAX's, so the values differ from its for a seed."""
    model = make_denoiser(meta)
    arch, dims = meta["arch"], meta.get("dims", 2)
    layout = arch_layout(arch, meta.get("nf", 48), meta.get("base_width", 11),
                         meta.get("top_width", 3))
    for mod, convs in layout.items():
        for idx, (k, cin, _) in convs.items():
            conv = getattr(model, mod)[int(idx)] if idx else getattr(model, mod)
            bound = 1.0 / np.sqrt(cin * k ** dims)
            for p in (conv.weight, conv.bias):
                if arch == "affine":
                    p.zero_()
                else:
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model


# ---------------------------------------------------------------------------
# numpy-only helpers (topaz_tpu/models/denoise.py:354-405, 444-476)
# ---------------------------------------------------------------------------

def _unet_layout(nf, base_width, top_width, levels=5):
    layout = {"enc1": {"0": (base_width, 1, nf)}}
    for i in range(2, levels + 1):
        layout[f"enc{i}"] = {"0": (3, nf, nf)}
    layout[f"enc{levels + 1}"] = {"0": (3, nf, nf)}
    first = True
    for d in range(levels, 1, -1):
        cin = 2 * nf if first else 3 * nf
        layout[f"dec{d}"] = {"0": (3, cin, 2 * nf), "2": (3, 2 * nf, 2 * nf)}
        first = False
    layout["dec1"] = {
        "0": (top_width, 2 * nf + 1, 64),
        "2": (top_width, 64, 32),
        "4": (top_width, 32, 1),
    }
    return layout


def min_input_size(arch: str) -> int:
    """Smallest spatial extent (per dimension) the arch's pooling pyramid
    accepts: each of the L pooling levels halves the grid, so an input
    below 2**L collapses an axis to zero mid-network. Callers turn this into
    an error naming the flag to raise."""
    if arch in ("unet", "unet3", "unet2"):
        return 32
    if arch == "unet-small":
        return 8
    return 1


def arch_layout(arch: str, nf: int = 48, base_width: int = 11,
                top_width: int = 3) -> Dict[str, Dict[str, Tuple[int, int, int]]]:
    """Conv shape layout {module: {idx: (kernel, cin, cout)}} per arch."""
    if arch in ("unet", "unet3"):
        return _unet_layout(nf, base_width, top_width, levels=5)
    if arch == "unet-small":
        return _unet_layout(nf, base_width, top_width, levels=3)
    if arch == "unet2":
        lay = _unet_layout(nf, base_width, top_width, levels=5)
        lay["dec2"] = {"0": (3, 2 * nf, 2 * nf), "2": (3, 2 * nf, 2 * nf)}
        lay["dec1"] = {"0": (top_width, 2 * nf, 64), "2": (top_width, 64, 32),
                       "4": (top_width, 32, 1)}
        return lay
    if arch == "fcnet":
        return {"net": {"0": (base_width, 1, nf), "2": (base_width, nf, nf),
                        "4": (base_width, nf, 1)}}
    if arch == "affine":
        return {"filter": {"": (31, 1, 1)}}
    raise ValueError(f"unknown denoiser arch: {arch}")


def denoiser_params_from_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """A torch denoiser state dict (enc1.0.weight, ...; the affine model's
    filter.weight) as the JAX package's tree (topaz_tpu/models/denoise.py:
    436-441)."""
    from topaz_tpu_torch.models.convert import params_tree_from_state_dict

    return params_tree_from_state_dict(sd, allow_bn=False)


def infer_denoiser_arch(sd: Dict[str, np.ndarray], class_name: str = None) -> Dict:
    """Guess (arch, nf, base_width, top_width, dims) from state-dict shapes.

    ``class_name`` (the pickled module's type name) resolves the one
    shape-ambiguous case: UDenoiseNet3 has UDenoiseNet's weight shapes but
    predicts the noise residual (reference models.py:447)."""
    if "filter.weight" in sd:
        return {"arch": "affine", "dims": 2}
    if "net.0.weight" in sd:
        w = sd["net.0.weight"]
        return {"arch": "fcnet", "nf": int(w.shape[0]),
                "base_width": int(w.shape[-1]), "dims": 2}
    w = sd["enc1.0.weight"]
    dims = w.ndim - 2
    nf = int(w.shape[0])
    base_width = int(w.shape[-1])
    top_width = int(sd["dec1.0.weight"].shape[-1])
    if "enc6.0.weight" in sd:
        dec1_in = sd["dec1.0.weight"].shape[1]
        if dec1_in == 2 * nf:
            arch = "unet2"
        elif class_name == "UDenoiseNet3":
            arch = "unet3"
        else:
            arch = "unet"
    else:
        arch = "unet-small"
    return {"arch": arch, "nf": nf, "base_width": base_width,
            "top_width": top_width, "dims": dims}
