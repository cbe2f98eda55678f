"""Operation counts of the benchmarked layers, from their shapes alone, and
the published peaks of the card they are held against.

A multiply-add counts as two operations. Counts are per valid (unpadded)
output pixel, whatever the program pads or recomputes.
"""

from __future__ import annotations

from typing import List, Sequence

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12
# the EM's bound: the SFU (MUFU) pipe, 16 results a clock on each of 132 SMs
# at the 1980 MHz boost clock
H100_MUFU_OPS = 132 * 16 * 1.98e9
# MUFU operations a posterior evaluation of one pixel and lane takes: the
# two exponentials and the logarithm of the log-sum-exp, and the two of the
# next step's responsibilities
EM_MUFU_PER_EVAL = 5


def picker_flops_per_pixel(layers: List[dict]) -> int:
    """Dense scoring's operations a score-map pixel: every convolution of
    the filled network and the 1x1 classifier, at stride 1."""
    total = 0
    for layer in layers:
        if layer["op"] == "conv":
            total += 2 * layer["k"] ** 2 * layer["cin"] * layer["cout"]
        else:
            total += 2 * 9 * layer["cin"] * layer["hidden"]
            total += 2 * 9 * layer["hidden"] * layer["cout"]
            if layer["cin"] != layer["cout"]:
                total += 2 * layer["cin"] * layer["cout"]
    return total + 2 * layers[-1]["cout"]


def unet_flops_per_pixel(nf: int, base_width: int, top_width: int, levels: int = 5) -> float:
    """The U-Net's operations an input pixel: level i runs at 4^-i of the
    pixels; the encoder's convolutions, the decoder's two a level on the
    concat of the upsampled map and the skip, and the top's three."""
    total = 2.0 * base_width ** 2 * nf
    for i in range(1, levels + 1):
        total += 2 * 9 * nf * nf / 4 ** i
    for d in range(levels, 1, -1):
        cin = 2 * nf if d == levels else 3 * nf
        total += (2 * 9 * cin * 2 * nf + 2 * 9 * 2 * nf * 2 * nf) / 4 ** (d - 1)
    t2 = top_width ** 2
    total += 2 * t2 * ((2 * nf + 1) * 64 + 64 * 32 + 32)
    return total


def em_evaluations(valid_pixels: int, steps: Sequence[int]) -> int:
    """Posterior evaluations of one image's EM fit: every valid pixel, for
    each lane, at the initialization and at each step that lane took."""
    return sum(valid_pixels * (1 + int(s)) for s in steps)


def em_bound_s(evaluations: int) -> float:
    """Least time the card takes for ``evaluations`` posterior evaluations."""
    return evaluations * EM_MUFU_PER_EVAL / H100_MUFU_OPS
