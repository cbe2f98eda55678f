"""Device selection for the port (the single-device part of
topaz_tpu/parallel/devices.py:70-92; device lists are parallel/devices.py).

Everything runs on a CUDA device unless the caller asks for the CPU by name.
There is no fallback: with no GPU, or a GPU index that does not exist, the
request raises instead of running somewhere else.

CLI ``-d/--device`` values: ``N >= 0`` -> ``cuda:N``, ``-1`` -> the current
CUDA device, ``cpu`` -> the CPU, ``-2`` -> the first of every visible CUDA
device (``parallel.devices.resolve_devices`` gives them all, for the paths
that shard over them).

Host data goes to a card and comes back through page-locked ("pinned")
host memory: ``as_device_tensor`` stages a large host array through the
card's small ring of reused pinned slots, ``to_host`` fetches into a pinned
buffer of PyTorch's caching host allocator. Module counters say how often
each route ran.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Union

import numpy as np
import torch

from topaz_tpu_torch.utils.batching import fetch_async

DeviceLike = Union[str, int, torch.device]


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was requested that this process cannot use."""


def exact_numerics() -> None:
    """The exact (f32) profile: no TF32 in matrix products or convolutions.
    cuDNN runs f32 convolutions in TF32 by default, which moves scores by
    about 1e-3 and can change picks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Resolve a device request (``"cuda"``, ``"cuda:N"``, ``"cpu"``, a
    ``torch.device`` or a CLI integer) to a ``torch.device``, raising when it
    names a CUDA device that is not there."""
    if isinstance(device, int):
        if device == -2:
            from topaz_tpu_torch.parallel.devices import resolve_devices

            return resolve_devices(-2)[0]
        if device < -1:
            raise ValueError(f"invalid device index {device}")
        device = "cuda" if device == -1 else f"cuda:{device}"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use cuda[:N] or cpu")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {dev} requested but no CUDA device is available; pass "
            f"device='cpu' (CLI: -d cpu) to run on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise DeviceUnavailableError(
            f"device {dev} requested but only {torch.cuda.device_count()} "
            f"CUDA device(s) are visible")
    exact_numerics()
    return dev


def parse_device_flag(value: str) -> DeviceLike:
    """argparse type of ``-d/--device``: ``cpu`` or an integer."""
    if value.strip().lower() == "cpu":
        return "cpu"
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"device must be an integer or 'cpu', got {value!r}") from None


# host data uploaded to a CUDA device through the staging ring, and its
# float32 bytes; host data uploaded to one the plain way (under
# STAGE_MIN_BYTES, non-contiguous, or not real numbers); device tensors
# fetched into pinned memory by to_host; in this process. Callers may reset
# each to 0
staged_uploads = 0
staged_bytes = 0
plain_uploads = 0
pinned_fetches = 0
_count_lock = threading.Lock()

# host data of at least this many float32 bytes goes through the ring
STAGE_MIN_BYTES = 1 << 20
# the ring of each CUDA device: SLOTS pinned float32 slots of SLOT_BYTES
SLOTS = 3
SLOT_BYTES = 16 << 20
# the fewest values a thread of a host cast copies
_PART = 1 << 16

_rings: Dict[torch.device, "StagingRing"] = {}
_rings_lock = threading.Lock()


class StagingRing:
    """Reused float32 host slots through which host data goes to a device,
    one slot-sized chunk at a time: each chunk is cast into a slot on the
    host, then copied to the device without waiting, so that the next
    chunk's host copy overlaps it. A slot is written again only after the
    event recorded behind its last copy has completed. Pinned for a CUDA
    device; made once and kept, so its pinned memory is bounded whatever the
    data's size. One upload at a time holds the ring.

    A numpy chunk is cast by ``np.copyto`` split over ``threads`` threads
    (numpy lets go of the interpreter lock while it copies), as PyTorch
    splits a tensor's ``copy_`` over its own: one thread copies a few GB/s,
    well under a pinned copy's rate to the card."""

    def __init__(self, pinned: bool, slots: int = SLOTS, slot_bytes: int = SLOT_BYTES,
                 threads: Optional[int] = None):
        self.slots = [torch.empty(slot_bytes // 4, dtype=torch.float32, pin_memory=pinned)
                      for _ in range(slots)]
        self.views = [s.numpy() for s in self.slots]
        self.events = [torch.cuda.Event() if pinned else None for _ in range(slots)]
        self.threads = max(1, threads or torch.get_num_threads())
        # the caller's thread copies one part; threads start at first use
        self._pool = (ThreadPoolExecutor(self.threads - 1, thread_name_prefix="staging")
                      if self.threads > 1 else None)
        self._next = 0
        self._lock = threading.Lock()

    def close(self) -> None:
        """Stop the cast threads; the ring's own live for the process."""
        if self._pool is not None:
            self._pool.shutdown()

    def _cast(self, dst: np.ndarray, src: np.ndarray) -> None:
        n = len(dst)
        parts = min(self.threads, max(1, n // _PART))
        cuts = [n * j // parts for j in range(parts + 1)]
        rest = [self._pool.submit(np.copyto, dst[a:b], src[a:b], casting="unsafe")
                for a, b in zip(cuts[1:-1], cuts[2:])]
        np.copyto(dst[:cuts[1]], src[:cuts[1]], casting="unsafe")
        for f in rest:
            f.result()

    def upload(self, src, out: torch.Tensor) -> None:
        """Copy ``src`` (a C-contiguous numpy array or CPU tensor of real
        numbers) into the float32 tensor ``out`` of as many elements, cast
        on the host as ``np.array(src, dtype=np.float32)`` casts. Copies to
        a CUDA ``out`` are issued on its device's current stream."""
        flat, dst = src.reshape(-1), out.view(-1)
        n, step = dst.numel(), self.slots[0].numel()
        stream = torch.cuda.current_stream(out.device) if out.is_cuda else None
        with self._lock:
            for lo in range(0, n, step):
                hi = min(n, lo + step)
                i = self._next
                self._next = (i + 1) % len(self.slots)
                event = self.events[i]
                if event is not None:
                    event.synchronize()  # its last copy has left the slot
                if isinstance(flat, torch.Tensor):
                    self.slots[i][:hi - lo].copy_(flat[lo:hi])
                else:
                    self._cast(self.views[i][:hi - lo], flat[lo:hi])
                dst[lo:hi].copy_(self.slots[i][:hi - lo], non_blocking=stream is not None)
                if event is not None:
                    event.record(stream)


def staging_ring(device: torch.device) -> StagingRing:
    """The CUDA ``device``'s ring, made at its first use."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = torch.device("cuda", index)
    with _rings_lock:
        ring = _rings.get(key)
        if ring is None:
            ring = _rings[key] = StagingRing(pinned=True)
    return ring


def _route(x, device: torch.device):
    """How ``x`` reaches ``device``: None where nothing goes from host to
    a card; "staged" through the card's ring for a C-contiguous numpy array
    of real numbers, or a contiguous CPU tensor (no autograd), of at least
    ``STAGE_MIN_BYTES`` as float32; "plain" for other host data."""
    if device.type != "cuda" or (isinstance(x, torch.Tensor) and x.device.type != "cpu"):
        return None
    if isinstance(x, np.ndarray):
        ok = x.dtype.kind in "biuf" and x.flags.c_contiguous
    elif isinstance(x, torch.Tensor):
        ok = (not x.is_complex() and x.is_contiguous() and not x.requires_grad
              and x.layout == torch.strided)
    else:
        ok = False
    return "staged" if ok and 4 * int(np.prod(x.shape)) >= STAGE_MIN_BYTES else "plain"


def _count(**deltas) -> None:
    g = globals()
    with _count_lock:
        for name, d in deltas.items():
            g[name] += d


def as_device_tensor(x, device: DeviceLike = "cuda") -> torch.Tensor:
    """``x`` (an array or a tensor) as a float32 tensor on ``device``.

    Host data (a numpy array or a CPU tensor) that ``_route`` stages goes
    through the card's ``StagingRing``, and the call returns once the last
    chunk's copy is issued; the values are those of ``np.array(x,
    dtype=np.float32)``, bit for bit. Anything else takes a float32 host
    copy (arrays read from files are read-only) and ``Tensor.to``."""
    dev = resolve_device(device)
    route = _route(x, dev)
    if route == "staged":
        out = torch.empty(tuple(x.shape), dtype=torch.float32, device=dev)
        staging_ring(dev).upload(x, out)
        _count(staged_uploads=1, staged_bytes=4 * out.numel())
        return out
    if route == "plain":
        _count(plain_uploads=1)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=dev, dtype=torch.float32)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array: a CUDA tensor copied without waiting into a
    pinned buffer of PyTorch's caching host allocator, then one
    synchronisation of its stream (``utils/batching.fetch_async``); the
    array is a view of that buffer, which goes back to the allocator when
    the array is dropped. A CPU tensor's own memory."""
    if t.is_cuda:
        _count(pinned_fetches=1)
    return fetch_async(t)[0]
