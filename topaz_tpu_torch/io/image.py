"""Image loading/saving for all formats the pipeline accepts.

Mirrors the behavioral contract of topaz/utils/data/loader.py:51-120 and
topaz/utils/image.py:88-147:
  * PNG/JPEG are stored quantized to uint8 over [-3, 3] sigma and are
    un-quantized on load; TIFF and MRC hold raw float data.
  * MRC loads return ``(array, header, extended_header)`` when asked.
  * ``save_image`` picks the writer from the extension or explicit format.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from topaz_tpu_torch.io import mrc


def quantize(x: np.ndarray, mi: float = -3, ma: float = 3, dtype=np.uint8) -> np.ndarray:
    """Affine-map [mi, ma] to [0, 255] and round (topaz/utils/image.py:88-97)."""
    if mi is None:
        mi = x.min()
    if ma is None:
        ma = x.max()
    y = 255 * (x - mi) / (ma - mi)
    y = np.clip(y, 0, 255)
    return np.round(y).astype(dtype)


def unquantize(x: np.ndarray, mi: float = -3, ma: float = 3, dtype=np.float32) -> np.ndarray:
    """Inverse of ``quantize`` up to rounding (topaz/utils/image.py:100-104)."""
    x = x.astype(dtype)
    return x * (ma - mi) / 255 + mi


def _load_pil(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def load_image(path: str, standardize: bool = False, make_image: bool = False,
               return_header: bool = False):
    """Load any supported image file as a float-compatible numpy array.

    For ``.mrc`` with ``return_header=True`` returns
    ``(array, header, extended_header)``. PNG/JPEG are unquantized from the
    +-3 sigma byte encoding (topaz/utils/data/loader.py:77-105).
    """
    ext = os.path.splitext(path)[1].lower()
    header = None
    ext_header = b""
    if ext == ".mrc" or ext == ".mrcs":
        x, header, ext_header = mrc.read(path)
        if x.dtype == np.float16:  # mode-12: promote (loader.py:55-56)
            x = x.astype(np.float32)
    elif ext in (".tiff", ".tif"):
        x = _load_pil(path)
    elif ext == ".png":
        x = unquantize(_load_pil(path))
    elif ext in (".jpg", ".jpeg"):
        x = unquantize(_load_pil(path))
    elif ext == ".npy":
        x = np.load(path)
    else:
        raise ValueError(f"Unsupported image format: {path}")

    if standardize:
        if header is not None and float(header.rms) > 0:
            # MRC standardizes by the HEADER statistics (loader.py:57-59)
            x = (x - float(header.amean)) / float(header.rms)
        else:
            x = (x - x.mean()) / x.std()

    if return_header:
        return x, header, ext_header
    return x


def save_image(x: np.ndarray, path: str, mi: float = -3, ma: float = 3,
               f: Optional[str] = None, verbose: bool = False,
               header=None, extended_header: bytes = b"") -> None:
    """Save by extension / explicit format (topaz/utils/image.py:107-124)."""
    if f is None:
        f = os.path.splitext(path)[1][1:]
    else:
        path = path + "." + f
    if verbose:
        print("# saving:", path, file=sys.stderr)

    x = np.asarray(x)
    if f == "mrc":
        mrc.write(path, x, header=header, extended_header=extended_header)
    elif f in ("tiff", "tif"):
        from PIL import Image

        Image.fromarray(x).save(path, "tiff")
    elif f == "png":
        from PIL import Image

        Image.fromarray(quantize(x, mi=mi, ma=ma)).save(path, "png")
    elif f in ("jpg", "jpeg"):
        from PIL import Image

        Image.fromarray(quantize(x, mi=mi, ma=ma)).save(path, "jpeg")
    elif f == "npy":
        np.save(path if path.endswith(".npy") else path + ".npy", x)
    else:
        raise ValueError(f"Unsupported output format: {f}")


def downsample_file(path: str, scale: int, output: str, verbose: bool = False,
                    device="cuda") -> np.ndarray:
    """Fourier-crop one file on ``device`` and save it
    (topaz/utils/image.py:64-85)."""
    from topaz_tpu_torch.ops.fourier import downsample

    loaded = load_image(path, return_header=True)
    image, header, ext_header = loaded
    image = image.astype(np.float32)

    small = downsample(image, scale, device=device).cpu().numpy()
    # the header keeps its ORIGINAL nx/ny here: mrc.write's shape-mismatch
    # branch then rescales mx/my along with nx/ny, keeping the physical
    # cell constant so the recorded voxel spacing doubles correctly

    if verbose:
        print("Downsample image:", path, file=sys.stderr)
        print("From", image.shape, "to", small.shape, file=sys.stderr)

    save_image(small, output, header=header, extended_header=ext_header)
    return small
