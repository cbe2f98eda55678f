"""The passes between the U-Net's convolutions on the card: wrapper of the
CUDA kernels ``csrc/unet_edges.cu``, and their plain PyTorch versions.

No TPU kernel is replaced: the JAX package left this glue to XLA's fusions.
After a cuDNN convolution run without its bias, one pass finishes the edge
to the next convolution:

  * ``bias_lrelu_``: the bias and leaky ReLU in place (the activation off for
    the last layer's bias);
  * ``bias_lrelu_pool``: the same, then the VALID 2x max (odd sizes floor),
    writing only the pooled map, which is the next level's input and the
    later skip;
  * ``bias_lrelu_up_cat``: the same on a level's low-resolution output,
    upsampled nearest with the integer source-index rule and written with
    its skip into the next convolution's input.

Each gives the bits of its plain version (``*_plain``: the modules' ops in
their order); the design is in csrc/unet_edges.cu, the times in PERF.md.
The wrappers take only contiguous float32 CUDA tensors of 2 or 3 spatial
axes and raise on anything else before any launch; the kernels build at
first use.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LEAK = 0.1

# launches of the kernels in this process; callers may reset it to 0
launches = 0
# the shards of a mesh call the kernels from threads of their own
# (parallel/mesh.run_each): one build, and no lost count
_lock = threading.Lock()

# a plane (one image's channel) holds fewer values than this, and an
# upsample's extents are at most _MAX_EXTENT: the kernels index in 32 bits
_MAX_PLANE = 2 ** 31 - 1
_MAX_EXTENT = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "unet_bias_lrelu": [_P, _P, _I, _I, ctypes.c_longlong, _I, _P],
    "unet_bias_lrelu_pool": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "unet_bias_lrelu_up_cat": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from topaz_tpu_torch._build import build_library

    with _lock:
        lib = ctypes.CDLL(build_library("unet_edges"))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """Source index of each output position of a nearest resize,
    ``(j * n_in) // n_out`` in integers (topaz_tpu/models/denoise.py:227-248).
    ``F.interpolate(mode='nearest')`` computes a float scale instead, which
    picks another source row for some odd sizes."""
    return (torch.arange(n_out, device=device) * n_in) // n_out


def up_nearest(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    """Nearest resize of the last ``len(size)`` axes of ``x`` to ``size``."""
    for axis, n_out in zip(range(-len(size), 0), size):
        n_in = x.shape[axis]
        if n_in != n_out:
            x = x.index_select(axis, nearest_index(n_in, n_out, x.device))
    return x


# -- shapes ------------------------------------------------------------------

def pool_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """(N, C, *spatial) after the VALID 2x max: each spatial extent halved,
    odd ones floored."""
    return (*shape[:2], *(s // 2 for s in shape[2:]))


def up_cat_shape(h_shape: Sequence[int], skip_channels: int,
                 size: Sequence[int]) -> Tuple[int, ...]:
    """(N, C1 + C2, *size): ``h_shape``'s C1 channels upsampled to ``size``
    and the skip's C2 after them."""
    return (h_shape[0], h_shape[1] + skip_channels, *size)


# -- plain versions -----------------------------------------------------------

def bias_lrelu_plain(x: torch.Tensor, bias: torch.Tensor, leaky: bool = True) -> torch.Tensor:
    """``x`` plus its channel's bias, then leaky ReLU unless ``leaky`` is
    off: a convolution's bias add and the module that follows it."""
    y = x + bias.reshape(1, -1, *[1] * (x.dim() - 2))
    return F.leaky_relu(y, LEAK) if leaky else y


def bias_lrelu_pool_plain(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    pool = F.max_pool2d if x.dim() == 4 else F.max_pool3d
    return pool(bias_lrelu_plain(x, bias), 2)


def bias_lrelu_up_cat_plain(h: torch.Tensor, bias: torch.Tensor, skip: Optional[torch.Tensor],
                            size: Sequence[int]) -> torch.Tensor:
    up = up_nearest(bias_lrelu_plain(h, bias), tuple(size))
    return up if skip is None else torch.cat([up, skip], dim=1)


# -- kernels -------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device}")


def _check_map(name: str, x: torch.Tensor, bias: torch.Tensor) -> None:
    """A (N, C, *spatial) map of 2 or 3 spatial axes and its (C,) bias on
    its device."""
    _check(name, x, "the map")
    _check(name, bias, "the bias")
    if x.dim() not in (4, 5):
        raise ValueError(f"{name}: expected (N, C, H, W) or (N, C, D, H, W), "
                         f"got {tuple(x.shape)}")
    if bias.shape != (x.shape[1],):
        raise ValueError(f"{name}: bias of shape {tuple(bias.shape)} for {x.shape[1]} channels")
    if bias.device != x.device:
        raise ValueError(f"{name}: bias on {bias.device}, map on {x.device}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty map {tuple(x.shape)}")
    _check_plane(name, x.shape[2:])


def _check_plane(name: str, spatial: Sequence[int]) -> None:
    if math.prod(spatial) > _MAX_PLANE:
        raise ValueError(f"{name}: a plane of {math.prod(spatial)} values exceeds {_MAX_PLANE}")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(_library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    global launches
    with _lock:
        launches += 1


def _spatial3(shape: Sequence[int]) -> Tuple[int, int, int]:
    """(D, H, W) of a map's spatial axes, D = 1 in 2D."""
    return (1, *shape) if len(shape) == 2 else tuple(shape)


def bias_lrelu_(x: torch.Tensor, bias: torch.Tensor, leaky: bool = True) -> torch.Tensor:
    """``bias_lrelu_plain`` written over ``x``, which is returned."""
    _check_map("bias_lrelu_", x, bias)
    _launch("unet_bias_lrelu", x.device, x.data_ptr(), bias.data_ptr(), x.shape[0],
            x.shape[1], math.prod(x.shape[2:]), int(leaky))
    return x


def bias_lrelu_pool(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``bias_lrelu_pool_plain`` into a new tensor of ``pool_shape``."""
    _check_map("bias_lrelu_pool", x, bias)
    shape = pool_shape(x.shape)
    if min(shape[2:]) < 1:
        raise ValueError(f"bias_lrelu_pool: {tuple(x.shape)} pools to {shape}")
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _launch("unet_bias_lrelu_pool", x.device, x.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], *_spatial3(x.shape[2:]), int(x.dim() == 5))
    return out


def bias_lrelu_up_cat(h: torch.Tensor, bias: torch.Tensor, skip: Optional[torch.Tensor],
                      size: Sequence[int]) -> torch.Tensor:
    """``bias_lrelu_up_cat_plain`` into a new tensor of ``up_cat_shape``:
    ``h`` upsampled to ``size`` and ``skip`` (None: no skip) after it."""
    _check_map("bias_lrelu_up_cat", h, bias)
    size = tuple(int(s) for s in size)
    if len(size) != h.dim() - 2:
        raise ValueError(f"bias_lrelu_up_cat: size {size} for a map {tuple(h.shape)}")
    c2 = 0
    if skip is not None:
        _check("bias_lrelu_up_cat", skip, "the skip")
        if (skip.device != h.device or skip.dim() != h.dim() or skip.shape[0] != h.shape[0]
                or tuple(skip.shape[2:]) != size):
            raise ValueError(f"bias_lrelu_up_cat: skip {tuple(skip.shape)} on {skip.device} "
                             f"for a map {tuple(h.shape)} on {h.device} upsampled to {size}")
        c2 = skip.shape[1]
    extents = (*h.shape[2:], *size)
    if min(extents) < 1 or max(extents) > _MAX_EXTENT:
        raise ValueError(f"bias_lrelu_up_cat: extents {extents} outside 1..{_MAX_EXTENT}")
    _check_plane("bias_lrelu_up_cat", size)
    out = torch.empty(up_cat_shape(h.shape, c2, size), dtype=h.dtype, device=h.device)
    _launch("unet_bias_lrelu_up_cat", h.device, h.data_ptr(), bias.data_ptr(),
            skip.data_ptr() if c2 else None, out.data_ptr(), h.shape[0], h.shape[1], c2,
            *_spatial3(h.shape[2:]), *_spatial3(size))
    return out
