"""Extra feature-extractor families: dense nets and multiscale residual nets
(port of topaz_tpu/models/extras.py:46-216, the reference's
topaz/model/features/densenet.py and msnet.py).

They are dead code in the reference (its arch lookup has no binding for
them) and the JAX package's picker factory does not read ``EXTRA_ARCHS``
either, so nothing here is wired into a command. Each family is an
``nn.Module`` on NCHW input whose ``state_dict()`` is the torch layout the
JAX package's ``extras_params_from_state_dict`` reads (``layers.N``,
``base.0``, ``blocks.N``, ``encoder_blocks.N``, ``decoder_blocks.N``,
``final_block.N``): one numpy state dict loads into both. No family has
batch norm, and ``load_extras_state_dict`` refuses its keys as the JAX
loader does. ``init_extras_`` draws fresh weights from a seeded generator.
Where the JAX apply functions take a size from the weights (channel counts,
the kernels of the SAME and head convolutions) the port fixes one, within
the receptive fields of the JAX package's ``EXTRA_ARCHS`` table: the
reference's modules are not in this repo.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from topaz_tpu_torch.models.convert import params_tree_from_state_dict


def _center_crop_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n = (x.shape[2] - h) // 2
    m = (x.shape[3] - w) // 2
    return x[:, :, n:n + h, m:m + w]


def _scale_pool(s: int) -> nn.MaxPool2d:
    """The shape-keeping max pool ahead of a dilation-s branch: window
    2(s-1)+1, padded by s-1 with -inf."""
    return nn.MaxPool2d(2 * (s - 1) + 1, stride=1, padding=s - 1)


def _same(nin: int, nout: int, k: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(nin, nout, k, dilation=dilation, padding=dilation * (k // 2))


# ---------------------------------------------------------------------------
# MultiscaleDenseNet (extras.py:46-65)
# ---------------------------------------------------------------------------

class MultiscaleDenseBlock(nn.Module):
    """Three SAME 3x3 convs at dilations 1, 2, 4, each fed the
    concatenation of the block's input and the earlier convs' outputs."""

    def __init__(self, units: int, ng: int):
        super().__init__()
        self.conv1 = _same(units, ng, 3, 1)
        self.conv2 = _same(units + ng, ng, 3, 2)
        self.conv3 = _same(units + 2 * ng, ng, 3, 4)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3):
            h = torch.cat([h, F.relu(conv(h))], dim=1)
        return h


class MultiscaleDenseNet(nn.Module):
    """SAME-padded dense blocks, each followed by a 1x1 projection back to
    ``base_units``, and a final dilation-12 7x7 conv (receptive field 73)."""

    def __init__(self, base_units: int = 64, ng: int = 32, num_blocks: int = 4):
        super().__init__()
        layers = [_same(1, base_units, 7), nn.ReLU()]
        for _ in range(num_blocks):
            layers += [MultiscaleDenseBlock(base_units, ng),
                       nn.Conv2d(base_units + 3 * ng, base_units, 1), nn.ReLU()]
        layers += [nn.Conv2d(base_units, base_units, 7, dilation=12), nn.ReLU()]
        self.layers = nn.Sequential(*layers)
        self.width = 73

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


# ---------------------------------------------------------------------------
# DenseNet (extras.py:72-90), VALID convs with centre-cropped concatenations
# ---------------------------------------------------------------------------

def densenet_width(num_layers: int = 12) -> int:
    width = 9
    for i in range(num_layers):
        width += 2 * (4, 2, 1)[i % 3] + 2
    return width + 6


class DenseLayer(nn.Module):
    def __init__(self, units: int, ng: int, bn_size: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Conv2d(units, bn_size * ng, 3, dilation=dilation)
        self.conv2 = nn.Conv2d(bn_size * ng, ng, 3)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        z = F.relu(self.conv2(F.relu(self.conv1(h))))
        return torch.cat([_center_crop_to(h, z.shape[2], z.shape[3]), z], dim=1)


class DenseNet(nn.Module):
    """A 7x7 conv and a 3x3 max pool, ``num_layers`` dense layers at
    dilations 4, 2, 1 in turn, and a 7x7 head."""

    def __init__(self, init_units: int = 64, ng: int = 32, bn_size: int = 4,
                 fc_units: int = 1000, num_layers: int = 12, bn: bool = False):
        super().__init__()
        if bn:
            raise ValueError("the extras' DenseNet has no batch norm (as the JAX "
                             "package's apply path); build it with bn=False")
        self.base = nn.Sequential(nn.Conv2d(1, init_units, 7), nn.ReLU(),
                                  nn.MaxPool2d(3, stride=1))
        units = init_units
        layers = []
        for i in range(num_layers):
            layers.append(DenseLayer(units, ng, bn_size, (4, 2, 1)[i % 3]))
            units += ng
        self.layers = nn.Sequential(*layers)
        self.fc = nn.Conv2d(units, fc_units, 7)
        self.width = densenet_width(num_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc(self.layers(self.base(x))))


# ---------------------------------------------------------------------------
# Residual multiscale blocks and nets (extras.py:97-153)
# ---------------------------------------------------------------------------

class ResidMultiScaleBlock(nn.Module):
    """Parallel dilated 3x3 branches (each behind a max pool at its scale,
    with a 1x1 projection), summed onto a centre-cropped skip path, which is
    projected by a bias-free 1x1 conv when the widths differ."""

    def __init__(self, nin: int, nout: int, scales: Tuple[int, ...] = (1, 2, 4),
                 padding: bool = False):
        super().__init__()
        self.proj = nn.Conv2d(nin, nout, 1, bias=False) if nin != nout else None
        blocks = []
        for s in scales:
            branch = [_scale_pool(s)] if s > 1 else []
            branch += [nn.Conv2d(nin, nout, 3, dilation=s, padding=s if padding else 0),
                       nn.ReLU(), nn.Conv2d(nout, nout, 1)]
            blocks.append(nn.Sequential(*branch))
        self.blocks = nn.ModuleList(blocks)
        self.width = 1 + (0 if padding else 2 * max(scales))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.proj is None else self.proj(x)
        for branch in self.blocks:
            z = branch(x)
            h = _center_crop_to(h, z.shape[2], z.shape[3]) + z
        return F.relu(h)


RMS_LAYOUTS = {
    # arch -> (units, per-block (scales, padding)); None: (1, 2, 4) unpadded
    # over units[1:-1]
    "rmsnet": ([64, 64, 64, 128, 128, 128, 128, 128, 128, 256, 256, 256], None),
    "rmsnet7": ([64, 64, 128, 128, 256],
                [((1, 2, 4), False), ((1, 2, 8), False), ((1, 2, 8), False),
                 ((1, 4, 16), False), ((1, 4, 16), False)]),
    "rmsnet10": ([64, 64, 128, 128, 256],
                 [((1, 2, 4), False), ((1, 2, 4), True), ((1, 2, 4), True),
                  ((1, 2, 8), False), ((1, 2, 8), False), ((1, 2, 8), True),
                  ((1, 4, 16), False), ((1, 4, 16), False)]),
}
# kernel of the first conv and of the head for each arch
_RMS_KERNELS = {"rmsnet": (11, 5), "rmsnet7": (11, 11), "rmsnet10": (11, 11)}


class RMSNet(nn.Module):
    """A conv, residual multiscale blocks and a conv head. The uniform
    ``rmsnet`` widens block by block along ``units[1:-1]``; ``rmsnet7`` and
    ``rmsnet10`` take ``units[1 + g]`` for the g-th run of equal scales."""

    def __init__(self, units: Optional[Sequence[int]] = None, arch: str = "rmsnet"):
        super().__init__()
        default_units, layout = RMS_LAYOUTS[arch]
        units = list(default_units if units is None else units)
        if layout is None:
            layout = [((1, 2, 4), False)] * len(units[1:-1])
            outs = units[1:-1]
        else:
            group, outs = 0, []
            for i, (scales, _) in enumerate(layout):
                group += i > 0 and scales != layout[i - 1][0]
                outs.append(units[1 + group])
        k_base, k_fc = _RMS_KERNELS[arch]
        self.base = nn.Sequential(nn.Conv2d(1, units[0], k_base), nn.ReLU())
        nin, blocks = units[0], []
        for nout, (scales, padding) in zip(outs, layout):
            blocks.append(ResidMultiScaleBlock(nin, nout, scales, padding))
            nin = nout
        self.layers = nn.Sequential(*blocks)
        self.fc = nn.Sequential(nn.Conv2d(nin, units[-1], k_fc), nn.ReLU())
        self.width = k_base + k_fc - 1 + sum(b.width - 1 for b in blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.layers(self.base(x)))


def RMSNet7(units: Optional[Sequence[int]] = None) -> RMSNet:
    return RMSNet(units, "rmsnet7")


def RMSNet10(units: Optional[Sequence[int]] = None) -> RMSNet:
    return RMSNet(units, "rmsnet10")


# ---------------------------------------------------------------------------
# PyramidNet (extras.py:160-192)
# ---------------------------------------------------------------------------

def pyramidnet_width(scales=(2, 4, 8, 16)) -> int:
    return sum(4 * s for s in list(scales)[::-1][1:]) + 9


class PyramidNet(nn.Module):
    """An encoder of SAME dilated conv pairs behind shape-keeping max pools,
    a decoder of VALID dilated conv pairs at the mirrored scales, each
    concatenated with the centre-cropped encoder output of its level, and
    two 5x5 convs."""

    def __init__(self, base_units: int = 64, scales: Sequence[int] = (2, 4, 8, 16)):
        super().__init__()
        u = base_units
        enc = [nn.Sequential(_same(1, u, 7), nn.ReLU())]
        for s in scales:
            enc.append(nn.Sequential(_scale_pool(s), _same(u, u, 3, s), nn.ReLU(),
                                     _same(u, u, 3, s), nn.ReLU()))
        self.encoder_blocks = nn.ModuleList(enc)
        dec, nin = [], u
        for s in list(reversed(scales))[1:]:
            dec.append(nn.Sequential(nn.Conv2d(nin, u, 3, dilation=s), nn.ReLU(),
                                     nn.Conv2d(u, u, 3, dilation=s), nn.ReLU()))
            nin = 2 * u
        self.decoder_blocks = nn.ModuleList(dec)
        self.final_block = nn.Sequential(nn.Conv2d(nin, u, 5), nn.ReLU(),
                                         nn.Conv2d(u, u, 5), nn.ReLU())
        self.width = pyramidnet_width(scales)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        zs = []
        h = x
        for block in self.encoder_blocks:
            h = block(h)
            zs.append(h)
        for block, skip in zip(self.decoder_blocks, zs[:-1][::-1]):
            h = block(h)
            h = torch.cat([_center_crop_to(skip, h.shape[2], h.shape[3]), h], dim=1)
        return self.final_block(h)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def load_extras_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]) -> nn.Module:
    """Load a numpy state dict into ``model`` (counterpart of the JAX
    package's ``extras_params_from_state_dict``). A batch-norm entry raises
    the JAX loader's ValueError: no family here applies batch norm, so its
    weights would be dropped."""
    params_tree_from_state_dict(sd, allow_bn=False)
    ref = next(model.parameters())
    model.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=ref.dtype)
                           for k, v in sd.items()})
    return model


def init_extras_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights from ``generator``: every conv's weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default scale."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / np.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
    return model


EXTRA_ARCHS = {
    "msdensenet": {"module": MultiscaleDenseNet, "width": 73},
    "densenet": {"module": DenseNet, "width": densenet_width()},
    "rmsnet": {"module": RMSNet, "width": 10 + 8 * 10 + 5},
    "rmsnet7": {"module": RMSNet7, "width": 125},
    "rmsnet10": {"module": RMSNet10, "width": 125},
    "pyramidnet": {"module": PyramidNet, "width": pyramidnet_width()},
}
