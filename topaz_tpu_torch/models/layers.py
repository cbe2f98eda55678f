"""Conv-net building blocks of the pickers (port of
topaz_tpu/models/layers.py:34-302), in the dense score-map form.

Each architecture is a static spec (a tuple of layer descriptors). In the
dense ("filled") form every stride-s layer runs at stride 1 with its
dilation multiplied by the accumulated stride, so the network maps a whole
micrograph to a per-pixel score map; this is what the reference does by
mutating modules at run time (fill()/unfill(),
topaz/model/features/resnet.py:31-44,87-99,153-176). Layout is NCHW with
OIHW kernels; all convolutions are VALID.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# layer specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvSpec:
    """BasicConv: conv [+ batchnorm] + activation
    (topaz/model/features/resnet.py:50-105)."""
    nin: int
    nout: int
    kernel: int
    stride: int = 1
    dilation: int = 1
    bn: bool = False
    activation: str = "relu"


@dataclass(frozen=True)
class ResidSpec:
    """ResidA residual block (topaz/model/features/resnet.py:108-204):
    conv0 3x3 -> act -> conv1 3x3 (dilation, stride) added to the
    edge-cropped (and 1x1-projected when nin != nout) input."""
    nin: int
    nhidden: int
    nout: int
    dilation: int = 1
    stride: int = 1
    bn: bool = False
    activation: str = "relu"

    @property
    def kernel(self) -> int:  # composite receptive field (resnet.py:138)
        return 2 * self.dilation + 3


@dataclass(frozen=True)
class PoolSpec:
    """Max or avg pooling with fill-aware dilation
    (topaz/model/features/resnet.py:10-47, basic.py:34-55)."""
    kernel: int
    stride: int
    kind: str = "max"
    padding: int = 0


@dataclass(frozen=True)
class DropoutSpec:
    rate: float


LayerSpec = Union[ConvSpec, ResidSpec, PoolSpec, DropoutSpec]


def receptive_field(specs: Sequence[LayerSpec]) -> int:
    """Input size producing one output (insize_from_outsize,
    topaz/model/utils.py:39-68). ResidA counts as one kernel-(2d+3) layer."""
    out = 1
    for spec in reversed(list(specs)):
        if isinstance(spec, DropoutSpec):
            continue
        k = spec.kernel
        s = spec.stride
        d = spec.dilation if isinstance(spec, ConvSpec) else 1
        pad = getattr(spec, "padding", 0)
        out = (out - 1) * s + 1 + (k - 1) * d - 2 * pad
    return out


def total_stride(specs: Sequence[LayerSpec]) -> int:
    st = 1
    for spec in specs:
        if isinstance(spec, DropoutSpec):
            continue
        st *= spec.stride
    return st


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------

def conv_nd(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
            dilation: int = 1) -> torch.Tensor:
    """VALID 2D convolution (cross-correlation), NCHW input, OIHW kernel."""
    return F.conv2d(x, w, b, stride=stride, dilation=dilation)


def pool_nd(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1,
            kind: str = "max", padding: int = 0) -> torch.Tensor:
    """Max or average pooling over the last two axes, with symmetric
    padding scaled by the dilation as the kernel is.

    avg follows torch AvgPool defaults (count_include_pad=True: padded zeros
    count toward the divisor). Written as shifted slices because torch's
    pools take no dilation for avg and no padding wider than half the
    kernel."""
    pad = padding * dilation
    if pad:
        x = F.pad(x, (pad, pad, pad, pad),
                  value=float("-inf") if kind == "max" else 0.0)
    H, W = x.shape[-2:]
    span = (kernel - 1) * dilation + 1
    Ho = (H - span) // stride + 1
    Wo = (W - span) // stride + 1
    out = None
    for i in range(kernel):
        for j in range(kernel):
            tap = x[..., i * dilation:i * dilation + (Ho - 1) * stride + 1:stride,
                    j * dilation:j * dilation + (Wo - 1) * stride + 1:stride]
            if out is None:
                out = tap
            elif kind == "avg":
                out = out + tap
            else:
                out = torch.maximum(out, tap)
    if kind == "avg":
        out = out / float(kernel ** 2)
    return out


def activate(x: torch.Tensor, activation: str, prelu=None) -> torch.Tensor:
    if activation == "relu":
        return F.relu(x)
    if activation == "prelu":
        # single learnable slope, torch nn.PReLU default
        a = prelu if prelu is not None else 0.25
        return torch.where(x >= 0, x, a * x)
    if activation == "leaky_relu":
        return F.leaky_relu(x, 0.01)
    if activation == "linear":
        return x
    raise ValueError(f"unknown activation: {activation}")


def batch_norm_apply(x: torch.Tensor, scale, bias, mean, var,
                     eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batchnorm over the channel axis (NCHW) with the running
    statistics."""
    shape = (1, -1, 1, 1)
    return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
            * scale.reshape(shape) + bias.reshape(shape))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """Parameters of one layer, named as in the JAX parameter tree
    (``conv_w``, ``conv0_b``, ``proj_w``, ...; batchnorm as ``bn_scale`` or
    ``bn0_mean``), with OIHW kernels. Created empty; the factory fills it."""

    def __init__(self, spec: LayerSpec):
        super().__init__()
        self.spec = spec

        def conv(name, nin, nout, k, bias):
            setattr(self, name + "_w", nn.Parameter(torch.zeros(nout, nin, k, k)))
            if bias:
                setattr(self, name + "_b", nn.Parameter(torch.zeros(nout)))

        def bn(name, n):
            setattr(self, name + "_scale", nn.Parameter(torch.ones(n)))
            setattr(self, name + "_bias", nn.Parameter(torch.zeros(n)))
            self.register_buffer(name + "_mean", torch.zeros(n))
            self.register_buffer(name + "_var", torch.ones(n))

        if isinstance(spec, ConvSpec):
            conv("conv", spec.nin, spec.nout, spec.kernel, bias=not spec.bn)
            if spec.bn:
                bn("bn", spec.nout)
        elif isinstance(spec, ResidSpec):
            conv("conv0", spec.nin, spec.nhidden, 3, bias=not spec.bn)
            conv("conv1", spec.nhidden, spec.nout, 3, bias=not spec.bn)
            if spec.bn:
                bn("bn0", spec.nhidden)
                bn("bn1", spec.nout)
            if spec.nin != spec.nout:
                conv("proj", spec.nin, spec.nout, 1, bias=False)
        if getattr(spec, "activation", None) == "prelu":
            self.prelu = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor, acc_stride: int) -> Tuple[torch.Tensor, int]:
        return apply_layer(self.spec, self, x, acc_stride)


def _bn(layer: Layer, name: str, x: torch.Tensor) -> torch.Tensor:
    return batch_norm_apply(x, getattr(layer, name + "_scale"), getattr(layer, name + "_bias"),
                            getattr(layer, name + "_mean"), getattr(layer, name + "_var"))


def apply_layer(spec: LayerSpec, layer: Layer, x: torch.Tensor,
                acc_stride: int) -> Tuple[torch.Tensor, int]:
    """Apply one layer in the dense form; returns (y, new_acc_stride). The
    effective dilation is the layer's dilation times the accumulated
    stride, and every stride is 1."""
    if isinstance(spec, DropoutSpec):
        return x, acc_stride
    prelu = getattr(layer, "prelu", None)

    if isinstance(spec, PoolSpec):
        y = pool_nd(x, spec.kernel, stride=1, dilation=acc_stride,
                    kind=spec.kind, padding=spec.padding)
        return y, acc_stride * spec.stride

    if isinstance(spec, ConvSpec):
        y = conv_nd(x, layer.conv_w, getattr(layer, "conv_b", None),
                    dilation=spec.dilation * acc_stride)
        if spec.bn:
            y = _bn(layer, "bn", y)
        return activate(y, spec.activation, prelu), acc_stride * spec.stride

    if isinstance(spec, ResidSpec):
        d0 = acc_stride                   # conv0 effective dilation
        d1 = spec.dilation * acc_stride   # conv1 effective dilation
        h = conv_nd(x, layer.conv0_w, getattr(layer, "conv0_b", None), dilation=d0)
        if spec.bn:
            h = _bn(layer, "bn0", h)
        h = activate(h, spec.activation, prelu)
        y = conv_nd(h, layer.conv1_w, getattr(layer, "conv1_b", None), dilation=d1)
        # skip path: crop the input to align with the valid-conv output
        # (resnet.py:185-197)
        edge = d0 + d1
        xc = x[..., edge:-edge, edge:-edge]
        if hasattr(layer, "proj_w"):
            xc = conv_nd(xc, layer.proj_w)
        y = y + xc
        if spec.bn:
            y = _bn(layer, "bn1", y)
        return activate(y, spec.activation, prelu), acc_stride * spec.stride

    raise TypeError(f"unknown layer spec: {spec}")
