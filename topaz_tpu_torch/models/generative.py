"""DCGAN-style transposed-convolution decoder of the autoencoder regularizer
(port of topaz_tpu/models/generative.py:1-111, the reference's
topaz/model/generative.py:31-65, used by ``train --autoencoder`` through
topaz/methods.py:11-23).

latent (B, nin) -> ConvT k4 s1 -> BN -> LeakyReLU(0.01) -> depth x [ConvT k4
s2 p1 -> BN -> LeakyReLU(0.01)] -> ConvT k3 s2 p1 -> (B, width, width), width
= 8 * 2**depth - 1. Batchnorm always normalizes with the batch's statistics
(eps 1e-5) and keeps no running statistics: the decoder exists only at
train time. Weights are torch's ``(Cin, Cout, k, k)``; the JAX package
stores ``(k, k, Cout, Cin)``, and ``generator_from_numpy`` /
``generator_to_numpy`` carry its tree ``{'0': {'w'}, 'bn0': {'scale',
'bias'}, ...}`` both ways.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def generator_width(depth: int) -> int:
    """Side of the decoder's output for ``depth`` stride-2 layers."""
    return 8 * 2**depth - 1


def layer_spec_for(depth: int) -> Tuple:
    """(kernel, stride, padding) of each transposed convolution."""
    return tuple([(4, 1, 0)] + [(4, 2, 1)] * depth + [(3, 2, 1)])


class Generator(nn.Module):
    """The decoder: ``forward`` is ``apply_generator`` of the JAX package
    with ``train=True``."""

    def __init__(self, nin: int, units: int = 32, depth: int = 3):
        super().__init__()
        self.spec = layer_spec_for(depth)
        scale = 2**depth
        widths = [nin] + [units * scale // 2**d for d in range(depth + 1)] + [1]
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros(cin, cout, k, k))
            for (k, _, _), cin, cout in zip(self.spec, widths[:-1], widths[1:]))
        self.bn_scale = nn.ParameterList(nn.Parameter(torch.ones(c)) for c in widths[1:-1])
        self.bn_bias = nn.ParameterList(nn.Parameter(torch.zeros(c)) for c in widths[1:-1])

    @property
    def width(self) -> int:
        return generator_width(len(self.spec) - 2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, nin) latents -> (B, width, width) images."""
        h = z.reshape(z.shape[0], -1, 1, 1)
        last = len(self.spec) - 1
        for i, ((_, stride, pad), w) in enumerate(zip(self.spec, self.weights)):
            h = F.conv_transpose2d(h, w, stride=stride, padding=pad)
            if i < last:
                h = F.batch_norm(h, None, None, self.bn_scale[i], self.bn_bias[i],
                                 training=True, eps=1e-5)
                h = F.leaky_relu(h, 0.01)
        return h[:, 0]


def init_generator(nin: int, generator: torch.Generator, units: int = 32,
                   depth: int = 3) -> Generator:
    """A decoder with fresh weights at torch's ConvTranspose2d default, as
    the JAX package draws them (topaz_tpu/models/generative.py:53-59):
    U(-b, b) with b = 1/sqrt(cout k^2), since a transposed convolution's fan
    is its output channels; batchnorm scale 1, bias 0. Drawn from
    ``generator`` in layer order."""
    model = Generator(nin, units, depth)
    with torch.no_grad():
        for w in model.weights:
            bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
            w.uniform_(-bound, bound, generator=generator)
    return model


def generator_from_numpy(params: Dict) -> Generator:
    """The port's decoder for the JAX package's tree of numpy arrays, on the
    CPU."""
    n_convs = sum(1 for k in params if not k.startswith("bn"))
    first = np.asarray(params["0"]["w"])
    model = Generator(first.shape[3], units=first.shape[2] // 2**(n_convs - 2),
                      depth=n_convs - 2)
    with torch.no_grad():
        for i, w in enumerate(model.weights):
            w.copy_(torch.tensor(np.asarray(params[str(i)]["w"], np.float32)
                                 .transpose(3, 2, 0, 1)))
        for i, (scale, bias) in enumerate(zip(model.bn_scale, model.bn_bias)):
            scale.copy_(torch.tensor(np.asarray(params[f"bn{i}"]["scale"], np.float32)))
            bias.copy_(torch.tensor(np.asarray(params[f"bn{i}"]["bias"], np.float32)))
    return model


def generator_to_numpy(model: Generator) -> Dict:
    """The JAX package's tree of ``model``, the inverse of
    ``generator_from_numpy``."""
    tree: Dict = {}
    for i, w in enumerate(model.weights):
        tree[str(i)] = {"w": np.ascontiguousarray(
            w.detach().cpu().numpy().transpose(2, 3, 1, 0))}
    for i, (scale, bias) in enumerate(zip(model.bn_scale, model.bn_bias)):
        tree[f"bn{i}"] = {"scale": scale.detach().cpu().numpy().copy(),
                          "bias": bias.detach().cpu().numpy().copy()}
    return tree
