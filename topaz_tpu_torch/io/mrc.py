"""MRC2000/IMOD image file reader and writer.

Host-side pure-numpy implementation built on a structured dtype for the
1024-byte header (the reference builds the same layout with struct format
strings, topaz/mrc.py:8-107). Behavioral contract with the reference:

  * ``parse`` returns ``(array, header, extended_header)``; volumes with
    nz == 1 are squeezed to 2D (topaz/mrc.py:125-127).
  * mode <-> dtype mapping covers modes 0,1,2,3,4,6,12,16
    (topaz/mrc.py:138-156).
  * ``write`` always casts to float32 / mode 2 and fills amin/amax/amean/rms
    from the data when no header is given (topaz/mrc.py:205-238).

Additions over the reference: memory-mapped access (``MrcMemmap``) so the
training crop sampler can gather random windows without reading whole files,
and explicit little-endian layout rather than native-endian structs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

HEADER_SIZE = 1024

# MRC2000 + IMOD extensions, fixed 1024-byte header, little-endian.
HEADER_DTYPE = np.dtype(
    [
        ("nx", "<i4"),
        ("ny", "<i4"),
        ("nz", "<i4"),
        ("mode", "<i4"),
        ("nxstart", "<i4"),
        ("nystart", "<i4"),
        ("nzstart", "<i4"),
        ("mx", "<i4"),
        ("my", "<i4"),
        ("mz", "<i4"),
        ("xlen", "<f4"),
        ("ylen", "<f4"),
        ("zlen", "<f4"),
        ("alpha", "<f4"),
        ("beta", "<f4"),
        ("gamma", "<f4"),
        ("mapc", "<i4"),
        ("mapr", "<i4"),
        ("maps", "<i4"),
        ("amin", "<f4"),
        ("amax", "<f4"),
        ("amean", "<f4"),
        ("ispg", "<i4"),
        ("next", "<i4"),
        ("creatid", "<i2"),
        ("extra1", "V30"),
        ("nint", "<i2"),
        ("nreal", "<i2"),
        ("extra2", "V20"),
        ("imodStamp", "<i4"),
        ("imodFlags", "<i4"),
        ("idtype", "<i2"),
        ("lens", "<i2"),
        ("nd1", "<i2"),
        ("nd2", "<i2"),
        ("vd1", "<i2"),
        ("vd2", "<i2"),
        ("tiltangles", "<f4", (6,)),
        ("xorg", "<f4"),
        ("yorg", "<f4"),
        ("zorg", "<f4"),
        ("cmap", "S4"),
        ("stamp", "S4"),
        ("rms", "<f4"),
        ("nlabl", "<i4"),
        ("labels", "S800"),
    ]
)
assert HEADER_DTYPE.itemsize == HEADER_SIZE

MODE_TO_DTYPE = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    3: np.dtype("<i2, <i2"),  # complex from two shorts
    4: np.dtype(np.complex64),
    6: np.dtype(np.uint16),
    12: np.dtype(np.float16),
    16: np.dtype("(3,)u1"),  # RGB
}

DTYPE_TO_MODE = {
    np.dtype(np.int8): 0,
    np.dtype(np.int16): 1,
    np.dtype(np.float32): 2,
    np.dtype(np.complex64): 4,
    np.dtype(np.uint16): 6,
    np.dtype(np.float16): 12,
}


@dataclass
class MrcHeader:
    """Typed view over the 1024-byte MRC header."""

    raw: np.ndarray  # 0-d structured array of HEADER_DTYPE

    def __getattr__(self, name):
        try:
            return self.raw[name][()]
        except Exception as e:  # pragma: no cover
            raise AttributeError(name) from e

    def replace(self, **kwargs) -> "MrcHeader":
        new = self.raw.copy()
        for k, v in kwargs.items():
            new[k] = v
        return MrcHeader(new)

    # compat with the reference's namedtuple API (header._replace(nx=...))
    _replace = replace

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (int(self.nz), int(self.ny), int(self.nx))

    @property
    def dtype(self) -> np.dtype:
        mode = int(self.mode)
        if mode not in MODE_TO_DTYPE:
            raise ValueError(f"Unknown MRC mode: {mode}")
        return MODE_TO_DTYPE[mode]

    @property
    def data_offset(self) -> int:
        return HEADER_SIZE + int(self.next)

    def tobytes(self) -> bytes:
        return self.raw.tobytes()


def default_header(
    shape: Tuple[int, int, int],
    dtype=np.float32,
    cella=(1.0, 1.0, 1.0),
    cellb=(0.0, 0.0, 0.0),
    mz: int = 1,
    amin: float = 0.0,
    amax: float = -1.0,
    amean: float = -2.0,
    rms: float = -1.0,
    exthd_size: int = 0,
    ispg: int = 0,
) -> MrcHeader:
    """Build a fresh header. Mirrors topaz/mrc.py:178-201 defaults."""
    raw = np.zeros((), dtype=HEADER_DTYPE)
    nz, ny, nx = shape
    raw["nx"], raw["ny"], raw["nz"] = nx, ny, nz
    raw["mode"] = DTYPE_TO_MODE[np.dtype(dtype)]
    raw["mx"], raw["my"], raw["mz"] = 1, 1, mz
    raw["xlen"], raw["ylen"], raw["zlen"] = cella
    raw["alpha"], raw["beta"], raw["gamma"] = cellb
    raw["mapc"], raw["mapr"], raw["maps"] = 1, 2, 3
    raw["amin"], raw["amax"], raw["amean"] = amin, amax, amean
    raw["ispg"] = ispg
    raw["next"] = exthd_size
    raw["rms"] = rms
    return MrcHeader(raw)


def parse_header(header_bytes: bytes) -> MrcHeader:
    """Parse the first 1024 bytes into a header (topaz/mrc.py:132-135)."""
    raw = np.frombuffer(header_bytes[:HEADER_SIZE], dtype=HEADER_DTYPE)[0].copy()
    return MrcHeader(raw)


def parse(content: bytes):
    """Parse a full MRC byte string -> (array, header, extended_header).

    nz == 1 volumes are squeezed to 2D, matching topaz/mrc.py:109-129.
    """
    header = parse_header(content[:HEADER_SIZE])
    ext = content[HEADER_SIZE : header.data_offset]
    n = int(header.nz) * int(header.ny) * int(header.nx)
    flat = np.frombuffer(content, dtype=header.dtype, offset=header.data_offset, count=-1)
    flat = flat[:n]
    # subarray dtypes (mode 16 RGB -> (3,)u1) add trailing channel axes;
    # the reference's reshape chokes on them (topaz/mrc.py:121) — fixed here
    array = flat.reshape(header.shape + flat.shape[1:])
    if int(header.nz) == 1:
        array = array[0]
    return array, header, ext


def read(path: str):
    """Read an MRC file -> (array, header, extended_header)."""
    with open(path, "rb") as f:
        return parse(f.read())


def read_header(f: BinaryIO) -> MrcHeader:
    """The header at the start of the open file ``f``."""
    head = f.read(HEADER_SIZE)
    if len(head) < HEADER_SIZE:
        raise ValueError(f"{getattr(f, 'name', f)}: {len(head)} bytes, "
                         f"shorter than an MRC header ({HEADER_SIZE})")
    return parse_header(head)


def readinto(f: BinaryIO, header: MrcHeader, out: np.ndarray) -> np.ndarray:
    """Read the data of the open MRC file ``f`` whose header is ``header``
    straight into ``out``, past the extended header, with no intermediate
    copy: ``out`` is C-contiguous, of the header's dtype and holds exactly
    nz * ny * nx values. Raises ValueError on a file shorter than that."""
    n = int(header.nz) * int(header.ny) * int(header.nx) * header.dtype.itemsize
    if out.dtype != header.dtype or out.nbytes != n or not out.flags.c_contiguous:
        raise ValueError(f"readinto: {out.dtype} {out.shape} cannot hold the data of "
                         f"{header.dtype} {header.shape}")
    view = memoryview(out.reshape(-1).view(np.uint8))
    f.seek(header.data_offset)
    got = 0
    while got < n:
        k = f.readinto(view[got:])
        if not k:
            raise ValueError(f"{getattr(f, 'name', f)}: MRC data ends after {got} of "
                             f"{n} bytes")
        got += k
    return out


def write(
    f: Union[str, BinaryIO],
    array: np.ndarray,
    header: Optional[MrcHeader] = None,
    extended_header: bytes = b"",
    ax: float = 1.0,
    ay: float = 1.0,
    az: float = 1.0,
    alpha: float = 0.0,
    beta: float = 0.0,
    gamma: float = 0.0,
) -> None:
    """Write float32/mode-2 MRC, computing stats when no header is supplied
    (contract of topaz/mrc.py:205-238)."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            write(fh, array, header=header, extended_header=extended_header,
                  ax=ax, ay=ay, az=az, alpha=alpha, beta=beta, gamma=gamma)
        return

    array = np.asarray(array)
    if array.ndim == 2:
        array = array[np.newaxis]
    array = array.astype(np.float32, copy=False)

    if header is None:
        header = default_header(
            array.shape,
            dtype=np.float32,
            cella=(ax, ay, az),
            cellb=(alpha, beta, gamma),
            mz=1,
            amin=float(array.min()),
            amax=float(array.max()),
            amean=float(array.mean()),
            rms=float(array.std()),
            exthd_size=len(extended_header),
        )
    else:
        # the extended-header length actually written wins over whatever
        # the caller's header claimed (a stale next would shift every
        # reader's data_offset into garbage)
        header = header.replace(mode=2, next=len(extended_header))
        nz, ny, nx = array.shape
        if (int(header.nx), int(header.ny), int(header.nz)) != (nx, ny, nz):
            # data was resized (e.g. denoise --downsample): never write a
            # stale-shape header; updating m* with n* keeps the physical
            # cell (cella) constant so the voxel spacing rescales correctly
            header = header.replace(nx=nx, ny=ny, nz=nz,
                                    mx=nx, my=ny, mz=nz)

    f.write(header.tobytes())
    f.write(extended_header)
    f.write(array.tobytes())


class MrcMemmap:
    """Memory-mapped MRC for random-window reads without full-file I/O.

    TPU-build addition: the training sampler gathers thousands of random
    crops per epoch; this replaces the reference's np.memmap wrapper
    (topaz/utils/data/memory_mapped_data.py:23-126) with zero-copy reads
    plus edge zero-padding identical in behavior to its ``get_crop``.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.header = parse_header(f.read(HEADER_SIZE))
        shape = self.header.shape
        if shape[0] == 1:
            shape = shape[1:]
        self.shape = shape
        self.dtype = self.header.dtype
        self._mm = np.memmap(
            path,
            dtype=self.dtype,
            mode="r",
            offset=self.header.data_offset,
            shape=self.header.shape,
        )
        if self.header.shape[0] == 1:
            self._mm = self._mm[0]

    def __getitem__(self, idx):
        return self._mm[idx]

    def crop(self, y0: int, x0: int, height: int, width: int) -> np.ndarray:
        """2D crop with zero padding for out-of-bounds regions
        (semantics of topaz/utils/data/memory_mapped_data.py:45-70)."""
        if self._mm.ndim != 2:
            raise ValueError(
                f"crop() reads 2D windows; {self.path} is a volume/stack "
                f"with shape {tuple(self.shape)} — index a section first "
                f"(e.g. mm[z])")
        H, W = self.shape[-2], self.shape[-1]
        out = np.zeros((height, width), dtype=np.float32)
        ys, ye = max(0, y0), min(H, y0 + height)
        xs, xe = max(0, x0), min(W, x0 + width)
        if ys < ye and xs < xe:
            out[ys - y0 : ye - y0, xs - x0 : xe - x0] = self._mm[ys:ye, xs:xe]
        return out
