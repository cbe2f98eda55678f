"""Conv-net building blocks of the pickers (port of
topaz_tpu/models/layers.py:34-363), in both forms one weight set serves.

Each architecture is a static spec (a tuple of layer descriptors).
  * strided ("training") form: convolutions keep their native strides, and
    a receptive-field-sized crop maps to one logit. Batchnorm may run in
    train mode (batch statistics, running statistics updated in place) and
    dropout draws from an explicit ``torch.Generator``.
  * dense ("filled") form: every stride-s layer runs at stride 1 with its
    dilation multiplied by the accumulated stride, so the network maps a
    whole micrograph to a per-pixel score map; this is what the reference
    does by mutating modules at run time (fill()/unfill(),
    topaz/model/features/resnet.py:31-44,87-99,153-176).
Layout is NCHW with OIHW kernels in 2D, NCDHW with OIDHW kernels in 3D
(tomograms); all convolutions are VALID.

A 3D convolution dilated d > 1 at stride 1 with 64 output channels or more,
on a float32 card tensor with no autograd graph to build, runs on the phase
route (``phase_conv3d``): one undilated convolution over the input's d^3
phase sub-volumes (a kernel deeper than 3 in depth slabs), the same
products summed, where cuDNN takes its plain implicit GEMM at wide tiles
rather than the 32x32 ones it gives dilated 3D convolutions. Anything else
runs ``F.conv2d``/``F.conv3d`` as it is. ``phase_convs`` and
``direct_dilated_convs`` count the dilated convolutions on each route.
"""

from __future__ import annotations

import itertools
import math
import threading
from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from topaz_tpu_torch.parallel.mesh import shared_sum

# dilated convolutions on the phase route and on the direct route in this
# process; callers may reset each to 0
phase_convs = 0
direct_dilated_convs = 0
_lock = threading.Lock()  # the counters, from a mesh's threads too


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
    """VALID convolution (cross-correlation): 2D for an OIHW kernel on NCHW,
    3D for an OIDHW kernel on NCDHW; on the phase route where
    ``phase_route`` says so."""
    if dilation > 1:
        phase = phase_route(x, w, b, stride, dilation)
        global phase_convs, direct_dilated_convs
        with _lock:
            if phase:
                phase_convs += 1
            else:
                direct_dilated_convs += 1
        if phase:
            return phase_conv3d(x, w, b, dilation)
    conv = F.conv3d if w.dim() == 5 else F.conv2d
    return conv(x, w, b, stride=stride, dilation=dilation)


def phase_route(x: torch.Tensor, w: torch.Tensor, b, stride: int, dilation: int) -> bool:
    """Whether a convolution runs on the phase route: a 5-D input, dilation
    above 1 at stride 1 (the form dense scoring runs), 64 output channels
    or more, input and kernel float32 on a card, and no autograd graph to
    build (gradients off, or nothing that requires one). The 2D pickers'
    dilated convolutions already take cuDNN's plain implicit GEMM; the CPU
    and training keep the direct convolution. So do fewer output channels:
    on an H100 cuDNN gives their phases its 64x32 tile, which gains less
    than the split and merge copies cost (the 3D resnet8's three 32 -> 32
    convolutions of a 166^3 tile: 20.9 ms direct, 22.4 ms on the route;
    its 32 -> 64 and 64 -> 64 ones: 39.0 ms direct, 28.6 ms on the route)."""
    if x.dim() != 5 or dilation <= 1 or stride != 1 or w.shape[0] < 64:
        return False
    if not (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32):
        return False
    tensors = (x, w) if b is None else (x, w, b)
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def _phase_runs(n: int, d: int):
    """An axis of length ``n`` as rows of ``d`` phases: its whole rows, then
    the part row of ``n % d``; for each, the slice of the axis, the rows and
    the phases."""
    whole = n // d
    runs = [(slice(0, whole * d), slice(0, whole), slice(0, d))] if whole else []
    if n % d:
        runs.append((slice(whole * d, n), slice(whole, whole + 1), slice(0, n % d)))
    return runs


def _phase_copy(flat: torch.Tensor, phases: torch.Tensor, d: int, split: bool) -> None:
    """Copy between ``flat`` (N, C, D, H, W) and ``phases`` (N, d, d, d, C,
    Dq, Hq, Wq), phase (a, b, c) of row (i, j, k) holding voxel (d i + a,
    d j + b, d k + c): into ``phases`` when ``split``, else into ``flat``.
    One strided copy a run of whole or part rows on each axis."""
    rows = phases.permute(0, 4, 5, 1, 6, 2, 7, 3)  # (N, C, Dq, d, Hq, d, Wq, d)
    for runs in itertools.product(*(_phase_runs(n, d) for n in flat.shape[2:])):
        f = flat[(Ellipsis,) + tuple(r[0] for r in runs)]
        for axis in (4, 3, 2):
            run = runs[axis - 2]
            f = f.unflatten(axis, (run[1].stop - run[1].start, run[2].stop))
        p = rows[(slice(None), slice(None)) + tuple(s for r in runs for s in r[1:])]
        (p if split else f).copy_(f if split else p)


def phase_conv3d(x: torch.Tensor, w: torch.Tensor, b, dilation: int) -> torch.Tensor:
    """``F.conv3d(x, w, b, dilation=dilation)`` (VALID, stride 1) as one
    undilated convolution over the d^3 phase sub-volumes of ``x``: with o =
    d q + p, x[o + d k] = x_p[q + k], so phase p of the output is phase p of
    the input convolved with ``w``. The input is copied once into
    phase-major order (N d^3, C, ceil(D/d), ceil(H/d), ceil(W/d)), the far
    end of an axis that is no multiple of d zero-filled; the output's
    phases are interleaved back and cropped to D - d (k - 1) (and so on)
    in one copy. Each output voxel is the same sum of the same products.

    A kernel deeper than 3 runs as the sum of its (1, k, k) depth slabs:
    cuDNN gives a 3D kernel of 5 its indexed implicit GEMM at 32x32 tiles,
    dilated or not, and a slab its 256x64 one (on an H100, the 3D resnet8's
    64 -> 128 5^3 convolution of a 166^3 tile: 92.7 ms whole, 45.9 ms in
    slabs on the phases)."""
    d = dilation
    n, c = x.shape[:2]
    rows = [-(-s // d) for s in x.shape[2:]]
    out = [s - d * (k - 1) for s, k in zip(x.shape[2:], w.shape[2:])]
    whole = all(s % d == 0 for s in x.shape[2:])
    xs = (x.new_empty if whole else x.new_zeros)((n, d, d, d, c, *rows))
    _phase_copy(x, xs, d, split=True)
    xs = xs.view(n * d ** 3, c, *rows)
    k = w.shape[2]
    if k <= 3:
        ys = F.conv3d(xs, w, b)
    else:
        depth = rows[0] - k + 1
        ys = F.conv3d(xs[:, :, :depth], w[:, :, :1], b)
        for a in range(1, k):
            ys += F.conv3d(xs[:, :, a:a + depth], w[:, :, a:a + 1])
    y = x.new_empty((n, w.shape[0], *out))
    _phase_copy(y, ys.view(n, d, d, d, *ys.shape[1:]), d, split=False)
    return y


def pool_nd(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1,
            kind: str = "max", padding: int = 0, dims: int = 2) -> torch.Tensor:
    """Max or average pooling over the last ``dims`` axes, with symmetric
    padding scaled by the dilation as the kernel is.

    avg follows torch AvgPool defaults (count_include_pad=True: padded zeros
    count toward the divisor). Written as shifted slices because torch's
    pools take no dilation for avg and no padding wider than half the
    kernel."""
    pad = padding * dilation
    if pad:
        x = F.pad(x, (pad, pad) * dims, value=float("-inf") if kind == "max" else 0.0)
    span = (kernel - 1) * dilation + 1
    outs = [(n - span) // stride + 1 for n in x.shape[-dims:]]
    out = None
    for taps in itertools.product(range(kernel), repeat=dims):
        tap = x[(Ellipsis,) + tuple(slice(t * dilation, t * dilation + (n - 1) * stride + 1,
                                          stride) for t, n in zip(taps, outs))]
        if out is None:
            out = tap
        elif kind == "avg":
            out = out + tap
        else:
            out = torch.maximum(out, tap)
    if kind == "avg":
        out = out / float(kernel ** dims)
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
    """Eval-mode batchnorm over the channel axis (NC...) with the running
    statistics."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
            * scale.reshape(shape) + bias.reshape(shape))


def batch_norm_train(x: torch.Tensor, scale, bias, mean, var,
                     momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode batchnorm with torch semantics (topaz_tpu/models/
    layers.py:191-209): normalizes with the batch's biased variance and
    updates the running ``mean`` and ``var`` buffers in place (when given),
    ``var`` with the unbiased variance, at ``momentum``. In a shard of a
    data-parallel step (parallel/mesh.StatSync) the batch is the step's
    whole batch: the per-channel sums of every shard and process."""
    allsum = shared_sum()
    if allsum is None:
        return F.batch_norm(x, mean, var, scale, bias, training=True,
                            momentum=momentum, eps=eps)
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    sums = allsum(torch.cat([x.sum(axes), x.new_full((1,), x.numel() // x.shape[1])]))
    n = sums[-1]
    centred = x - (sums[:-1] / n).reshape(shape)
    biased = allsum((centred * centred).sum(axes)) / n
    if mean is not None:
        with torch.no_grad():
            mean.lerp_(sums[:-1] / n, momentum)
            var.lerp_(biased * n / (n - 1), momentum)
    return (centred * torch.rsqrt(biased + eps).reshape(shape) * scale.reshape(shape)
            + bias.reshape(shape))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate, scaled
    by 1 / (1 - rate), from uniforms drawn with ``generator`` (on x's
    device)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """Parameters of one layer, named as in the JAX parameter tree
    (``conv_w``, ``conv0_b``, ``proj_w``, ...; batchnorm as ``bn_scale`` or
    ``bn0_mean``), with OIHW kernels (OIDHW when ``dims`` is 3). Created
    empty; the factory fills it."""

    def __init__(self, spec: LayerSpec, dims: int = 2):
        super().__init__()
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        self.spec = spec
        self.dims = dims

        def conv(name, nin, nout, k, bias):
            setattr(self, name + "_w", nn.Parameter(torch.zeros((nout, nin) + (k,) * dims)))
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

    def forward(self, x: torch.Tensor, acc_stride: int, dense: bool = True,
                train: bool = False, generator=None) -> Tuple[torch.Tensor, int]:
        return apply_layer(self.spec, self, x, acc_stride, dense=dense, train=train,
                           generator=generator)


def _bn(layer: Layer, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    norm = batch_norm_train if train else batch_norm_apply
    return norm(x, getattr(layer, name + "_scale"), getattr(layer, name + "_bias"),
                getattr(layer, name + "_mean"), getattr(layer, name + "_var"))


def apply_layer(spec: LayerSpec, layer: Layer, x: torch.Tensor, acc_stride: int,
                dense: bool = True, train: bool = False,
                generator=None) -> Tuple[torch.Tensor, int]:
    """Apply one layer; returns (y, new_acc_stride) (topaz_tpu/models/
    layers.py:216-302). ``dense``: the filled form, every stride 1 and the
    effective dilation the layer's times the accumulated stride; else the
    strided form, native strides at base dilation 1. ``train``: batchnorm
    from batch statistics (running ones updated in place), and dropout when
    a ``generator`` is given."""
    if isinstance(spec, DropoutSpec):
        if train and spec.rate > 0 and generator is not None:
            x = dropout(x, spec.rate, generator)
        return x, acc_stride
    prelu = getattr(layer, "prelu", None)
    stride, base_dil = (1, acc_stride) if dense else (spec.stride, 1)

    if isinstance(spec, PoolSpec):
        y = pool_nd(x, spec.kernel, stride=stride, dilation=base_dil,
                    kind=spec.kind, padding=spec.padding, dims=layer.dims)
        return y, acc_stride * spec.stride

    if isinstance(spec, ConvSpec):
        y = conv_nd(x, layer.conv_w, getattr(layer, "conv_b", None), stride=stride,
                    dilation=spec.dilation * base_dil)
        if spec.bn:
            y = _bn(layer, "bn", y, train)
        return activate(y, spec.activation, prelu), acc_stride * spec.stride

    if isinstance(spec, ResidSpec):
        d0 = base_dil                     # conv0 effective dilation
        d1 = spec.dilation * base_dil     # conv1 effective dilation
        h = conv_nd(x, layer.conv0_w, getattr(layer, "conv0_b", None), dilation=d0)
        if spec.bn:
            h = _bn(layer, "bn0", h, train)
        h = activate(h, spec.activation, prelu)
        y = conv_nd(h, layer.conv1_w, getattr(layer, "conv1_b", None), stride=stride,
                    dilation=d1)
        # skip path: crop the input to align with the valid-conv output
        # (resnet.py:185-197), then project or subsample it by the stride
        edge = d0 + d1
        xc = x[(Ellipsis,) + (slice(edge, -edge),) * layer.dims]
        if hasattr(layer, "proj_w"):
            xc = conv_nd(xc, layer.proj_w, stride=stride)
        elif stride > 1:
            xc = xc[(Ellipsis,) + (slice(None, None, stride),) * layer.dims]
        y = y + xc
        if spec.bn:
            y = _bn(layer, "bn1", y, train)
        return activate(y, spec.activation, prelu), acc_stride * spec.stride

    raise TypeError(f"unknown layer spec: {spec}")


def init_layer_(layer: Layer, generator: torch.Generator) -> None:
    """Draw one layer's kernels and biases at the JAX package's scales
    (topaz_tpu/models/layers.py:309-363, torch's conv default):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = nin k^dims, from
    ``generator``. Batchnorm (scale 1, bias 0, running mean 0, var 1) and
    PReLU (0.25) keep the values the layer is built with."""
    with torch.no_grad():
        for name in ("conv", "conv0", "conv1", "proj"):
            w = getattr(layer, name + "_w", None)
            if w is None:
                continue
            bound = 1.0 / math.sqrt(w[0].numel())
            w.uniform_(-bound, bound, generator=generator)
            b = getattr(layer, name + "_b", None)
            if b is not None:
                b.uniform_(-bound, bound, generator=generator)
