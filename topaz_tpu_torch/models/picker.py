"""Particle-picker classifiers: feature extractor + 1x1 linear head (port
of topaz_tpu/models/picker.py:38-324).

Architecture registry mirroring the reference's model zoo:
  * resnet8 / resnet16 / resnet6 (topaz/model/features/resnet.py:254-339)
  * conv31 / conv63 / conv127    (topaz/model/features/basic.py:12-111,
    topaz/model/factory.py:15-25)
``Picker`` is the dense score-map form: an (N, H, W) micrograph batch in,
an (N, H, W) score map out (zero-padded by width//2 first).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from topaz_tpu_torch.models.layers import (
    ConvSpec,
    DropoutSpec,
    Layer,
    LayerSpec,
    PoolSpec,
    ResidSpec,
    conv_nd,
    receptive_field,
    total_stride,
)


def _units3(units) -> List[int]:
    if units is None:
        return [32, 64, 128]
    if isinstance(units, (list, tuple)):
        return list(units)
    u = int(units)
    return [u, 2 * u, 4 * u]


def resnet8_spec(units=32, bn=False, dropout=0.0, pooling=None,
                 activation="relu") -> List[LayerSpec]:
    """ResNet8 (topaz/model/features/resnet.py:280-306)."""
    u = _units3(units)
    stride = 1 if pooling == "max" else 2
    specs: List[LayerSpec] = [
        ConvSpec(1, u[0], 7, stride=stride, bn=bn, activation=activation)
    ]
    if pooling == "max":
        specs += [PoolSpec(3, 2)]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    specs += [
        ResidSpec(u[0], u[0], u[0], dilation=2, bn=bn, activation=activation),
        ResidSpec(u[0], u[0], u[1], dilation=2, stride=stride, bn=bn, activation=activation),
    ]
    if pooling == "max":
        specs += [PoolSpec(3, 2)]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    specs += [
        ResidSpec(u[1], u[1], u[1], dilation=2, bn=bn, activation=activation),
        ConvSpec(u[1], u[2], 5, bn=bn, activation=activation),
    ]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    return specs


def resnet16_spec(units=32, bn=False, dropout=0.0, pooling=None,
                  activation="relu") -> List[LayerSpec]:
    """ResNet16 (topaz/model/features/resnet.py:309-339)."""
    u = _units3(units)
    stride = 1 if pooling == "max" else 2
    specs: List[LayerSpec] = [
        ConvSpec(1, u[0], 7, bn=bn, activation=activation),
        ResidSpec(u[0], u[0], u[0], stride=stride, bn=bn, activation=activation),
    ]
    if pooling == "max":
        specs += [PoolSpec(3, 2)]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    specs += [
        ResidSpec(u[0], u[0], u[0], bn=bn, activation=activation),
        ResidSpec(u[0], u[0], u[0], bn=bn, activation=activation),
        ResidSpec(u[0], u[0], u[0], bn=bn, activation=activation),
        ResidSpec(u[0], u[0], u[1], stride=stride, bn=bn, activation=activation),
    ]
    if pooling == "max":
        specs += [PoolSpec(3, 2)]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    specs += [
        ResidSpec(u[1], u[1], u[1], bn=bn, activation=activation),
        ResidSpec(u[1], u[1], u[1], bn=bn, activation=activation),
        ConvSpec(u[1], u[2], 5, bn=bn, activation=activation),
    ]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    return specs


def resnet6_spec(units=32, bn=True, dropout=0.0, pooling=None,
                 activation="relu") -> List[LayerSpec]:
    """ResNet6 (topaz/model/features/resnet.py:254-277)."""
    u = _units3(units)
    specs: List[LayerSpec] = [
        ConvSpec(1, u[0], 5, bn=bn, activation=activation),
        PoolSpec(3, 2),
    ]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    specs += [
        ResidSpec(u[0], u[0], u[1], dilation=4, bn=bn, activation=activation),
        PoolSpec(3, 2),
    ]
    if dropout > 0:
        specs += [DropoutSpec(dropout)]
    specs += [
        ResidSpec(u[1], u[1], u[1], dilation=2, bn=bn, activation=activation),
        ConvSpec(u[1], u[2], 5, bn=bn, activation=activation),
    ]
    return specs


def basic_conv_spec(layers: Sequence[int], units: int, unit_scaling: int = 1,
                    dropout: float = 0.0, bn: bool = True, pooling=None,
                    activation: str = "prelu") -> List[LayerSpec]:
    """BasicConv stack (topaz/model/features/basic.py:12-111)."""
    stride = 1 if pooling in ("max", "avg") else 2
    specs: List[LayerSpec] = []
    nin = 1
    u = units
    for k in list(layers)[:-1]:
        specs.append(ConvSpec(nin, u, k, stride=stride, bn=bn, activation=activation))
        if pooling in ("max", "avg"):
            # padded pool keeps conv31/63/127 receptive fields at their
            # names (basic.py:55 pools with padding=1)
            specs.append(PoolSpec(3, 2, kind=pooling, padding=1))
        if dropout > 0:
            specs.append(DropoutSpec(dropout))
        nin = u
        u *= unit_scaling
    specs.append(ConvSpec(nin, u, list(layers)[-1], bn=bn, activation=activation))
    if dropout > 0:
        specs.append(DropoutSpec(dropout))
    return specs


def conv127_spec(units=32, **kw):
    """conv127 arch (topaz/model/factory.py registry entry)."""
    return basic_conv_spec([7, 5, 5, 5, 5], units, **kw)


def conv63_spec(units=32, **kw):
    """conv63 arch (topaz/model/factory.py registry entry)."""
    return basic_conv_spec([7, 5, 5, 5], units, **kw)


def conv31_spec(units=32, **kw):
    """conv31 arch (topaz/model/factory.py registry entry)."""
    return basic_conv_spec([7, 5, 5], units, **kw)


ARCHITECTURES = {
    "resnet8": resnet8_spec,
    "resnet16": resnet16_spec,
    "resnet6": resnet6_spec,
    "conv127": conv127_spec,
    "conv63": conv63_spec,
    "conv31": conv31_spec,
}


def _latent_dim(specs: Sequence[LayerSpec]) -> int:
    for spec in reversed(list(specs)):
        if isinstance(spec, (ConvSpec, ResidSpec)):
            return spec.nout
    raise ValueError("no conv layers in spec")


@dataclass(frozen=True)
class PickerSpec:
    """Static description of a picker: features + 1x1 classifier head.

    ``config`` records the constructor kwargs (as a hashable sorted tuple)
    so checkpoints can rebuild the exact spec including dropout/pooling."""

    arch: str
    features: Tuple[LayerSpec, ...]
    dims: int = 2
    config: Optional[Tuple] = None

    @property
    def width(self) -> int:
        return receptive_field(self.features)

    @property
    def stride(self) -> int:
        return total_stride(self.features)

    @property
    def latent_dim(self) -> int:
        return _latent_dim(self.features)


def make_picker_spec(arch: str, units=32, bn: bool = False, dropout: float = 0.0,
                     pooling=None, unit_scaling: int = 2, dims: int = 2,
                     activation: Optional[str] = None) -> PickerSpec:
    """Resolve an arch name to its static layer spec (factory.py:28-30, sans eval())."""
    if arch not in ARCHITECTURES:
        raise ValueError(
            f"unknown architecture {arch!r}; available: {sorted(ARCHITECTURES)}"
        )
    if arch.startswith("resnet") and pooling not in (None, "max"):
        # the reference crashes on anything else ('avg' stays a string and
        # gets called, resnet.py:214-218 + 290); fail with the contract
        raise ValueError(
            f"resnet architectures support pooling='max' only, got "
            f"{pooling!r} (conv31/63/127 also accept 'avg')")
    kw = dict(units=units, bn=bn, dropout=dropout, pooling=pooling)
    if arch.startswith("conv"):
        kw["unit_scaling"] = unit_scaling
        if activation is not None:
            kw["activation"] = activation
    elif activation is not None:
        kw["activation"] = activation
    specs = ARCHITECTURES[arch](**kw)
    config = tuple(sorted({**kw, "unit_scaling": unit_scaling,
                           "dims": dims}.items()))
    return PickerSpec(arch=arch, features=tuple(specs), dims=dims,
                      config=config)


class Picker(nn.Module):
    """Dense-form picker: ``forward`` is apply_picker(dense=True) of the
    JAX package (topaz_tpu/models/picker.py:266-324)."""

    def __init__(self, spec: PickerSpec):
        super().__init__()
        if spec.dims != 2:
            raise NotImplementedError(
                "3D pickers (--dims 3) are not yet ported to topaz_tpu_torch")
        self.spec = spec
        self.layers = nn.ModuleList(Layer(s) for s in spec.features)
        self.classifier_w = nn.Parameter(torch.zeros(1, spec.latent_dim, 1, 1))
        self.classifier_b = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W) images -> (N, H, W) scores (logits)."""
        p = self.spec.width // 2
        x = F.pad(x[:, None], (p, p, p, p))
        acc = 1
        for layer in self.layers:
            x, acc = layer(x, acc)
        return conv_nd(x, self.classifier_w, self.classifier_b)[:, 0]
