"""The disk max-filter on the card: wrapper of the CUDA kernels
``csrc/disk_max.cu``.

Replaces the TPU kernel ``_disk_max_kernel`` / ``disk_max_pallas``
(topaz_tpu/ops/nms_pallas.py:35-119). On paper the function is bound by its
bytes at r = 14 (8 a pixel: 2 MB and 0.6 us at 3.35 TB/s on the main path's
512 x 512 map) and by its ~4r chord maxima a pixel at r = 100; the kernels
are held by the instructions of their build steps. Each costs O(r + r^2 / T)
a pixel, T the tile's 16 or 32 rows: a lane owns a column and builds the
chord maxima of each row incrementally in registers, the tile's own rows up
to width r and its halo rows only as wide as their chords. Where its block
fits in shared memory (on an H100, r <= 85 at widths of 128 or more) the
window kernel keeps the block's whole window there and the tile's outputs in
registers; elsewhere the row kernel streams row segments through a two-row
ring and folds into accumulators in shared memory. The launcher picks the
kernel and its warps; the design is in csrc/disk_max.cu, the measured times
in PERF.md.

A tensor on the CPU goes to the plain version (ops/nms.disk_max); a CUDA
tensor always goes to the kernel, which builds at first use.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from topaz_tpu_torch.ops.nms import _chords_2d
from topaz_tpu_torch.ops.nms import disk_max as disk_max_plain

# launches of the kernel in this process; callers may reset it to 0
launches = 0
# the shards of a mesh call the kernel from threads of their own
# (parallel/mesh.run_each): one build, and no lost count
_lock = threading.Lock()

_ENTRY = {torch.float32: ("disk_max_f32", ctypes.c_float, float),
          torch.int32: ("disk_max_i32", ctypes.c_int, int)}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from topaz_tpu_torch._build import build_library

    with _lock:
        lib = ctypes.CDLL(build_library("disk_max"))
    for name, ctype, _ in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctype, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _chord_table(r: int, device: torch.device) -> torch.Tensor:
    """half_width[dy + r] for dy in [-r, r], computed as ops/nms._chords_2d."""
    half = [0] * (2 * r + 1)
    for w, dys in _chords_2d(r).items():
        for dy in dys:
            half[dy + r] = w
    return torch.tensor(half, dtype=torch.int32, device=device)


def disk_max(x: torch.Tensor, r: int, init) -> torch.Tensor:
    """Max over the clipped integer disk of radius ``r`` around every pixel
    of an (H, W) or (B, H, W) float32 or int32 tensor; taps outside the image
    read ``init``."""
    if x.device.type == "cpu":
        return disk_max_plain(x, r, init)
    if x.device.type != "cuda":
        raise ValueError(f"disk_max: no kernel for device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"disk_max: dtype {x.dtype} is not float32 or int32")
    if x.dim() not in (2, 3):
        raise ValueError(f"disk_max: expected (H, W) or (B, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("disk_max: input must be contiguous")
    r = int(r)
    if r < 0:
        raise ValueError(f"disk_max: radius must be >= 0, got {r}")
    B = x.shape[0] if x.dim() == 3 else 1
    H, W = x.shape[-2:]
    if B > 65535:
        raise ValueError(f"disk_max: batch {B} exceeds the grid's 65535")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # a disk of radius H + W - 2 already covers the whole image from every
    # pixel, so a larger one gives the same maxima
    r = min(r, H + W - 2)
    name, ctype, cast = _ENTRY[x.dtype]
    fn = getattr(_library(), name)
    with torch.cuda.device(x.device):
        chords = _chord_table(r, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), chords.data_ptr(), B, H, W, r,
                 ctype(cast(init)), stream)
    if err != 0:
        raise RuntimeError(f"disk_max kernel launch failed with CUDA error {err}")
    global launches
    with _lock:
        launches += 1
    return out
