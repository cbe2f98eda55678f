"""ctypes wrappers of the host crop gather (``csrc/cropgather.c``, the port's
copy of topaz_tpu/native/cropgather.c).

The library is built by the system C compiler into the package's
``_build/`` directory at first use (``_build.build_c_library``); a failed
build raises. The numpy versions in ``train/data.py`` compute the same
crops and serve the tests only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.int16): 1,
    np.dtype(np.int8): 2,
    np.dtype(np.uint16): 3,
    np.dtype(np.float64): 4,
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library, building it first when needed."""
    from topaz_tpu_torch._build import build_c_library

    lib = ctypes.CDLL(build_c_library("cropgather"))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gather_crops.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.gather_crops.restype = None
    lib.gather_rotated_crops.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.gather_rotated_crops.restype = None
    return lib


def _image_args(image: np.ndarray):
    code = _DTYPE_CODES.get(image.dtype)
    if code is None or image.ndim != 2 or not image.flags["C_CONTIGUOUS"]:
        raise ValueError(f"the crop gather reads C-contiguous 2D images of "
                         f"{sorted(str(d) for d in _DTYPE_CODES)}; got {image.dtype} "
                         f"{image.shape}")
    return image.ctypes.data_as(ctypes.c_void_p), code, image.shape[0], image.shape[1]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def gather_crops(image: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                 size: int) -> np.ndarray:
    """(n, size, size) float32 windows with top-left corners (ys[i], xs[i])
    of a 2D image, zero outside it."""
    args = _image_args(image)
    ys = np.ascontiguousarray(ys, dtype=np.int64)
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    out = np.empty((len(ys), size, size), dtype=np.float32)
    load_library().gather_crops(*args, _ptr(ys, ctypes.c_int64), _ptr(xs, ctypes.c_int64),
                                len(ys), size, _ptr(out, ctypes.c_float))
    return out


def gather_rotated_crops(image: np.ndarray, cys: np.ndarray, cxs: np.ndarray,
                         angles: np.ndarray, hflip: np.ndarray, vflip: np.ndarray,
                         size: int) -> np.ndarray:
    """(n, size, size) float32 windows centered at (cys, cxs), rotated by
    ``angles`` radians (counter-clockwise, nearest neighbour) and flipped,
    zero outside the image."""
    args = _image_args(image)
    cys = np.ascontiguousarray(cys, dtype=np.int64)
    cxs = np.ascontiguousarray(cxs, dtype=np.int64)
    angles = np.ascontiguousarray(angles, dtype=np.float64)
    hflip = np.ascontiguousarray(hflip, dtype=np.uint8)
    vflip = np.ascontiguousarray(vflip, dtype=np.uint8)
    out = np.empty((len(cys), size, size), dtype=np.float32)
    load_library().gather_rotated_crops(
        *args, _ptr(cys, ctypes.c_int64), _ptr(cxs, ctypes.c_int64),
        _ptr(angles, ctypes.c_double), _ptr(hflip, ctypes.c_uint8),
        _ptr(vflip, ctypes.c_uint8), len(cys), size, _ptr(out, ctypes.c_float))
    return out
