"""Host<->device copies and the page-locked ("pinned") host memory they go
through. Each pinned block is a ``_Block``, written or handed out again only
once the event behind its last copy has completed: the slots of
``StagingRing`` (``as_device_tensor``), the frames of ``FramePool`` (the
batched pipeline's raw micrographs) and ``fetch_later``'s buffers; ``fetch``
and ``to_host`` copy into pinned buffers of PyTorch's caching host allocator
with one synchronisation a stream. Module counters say how often each route
ran; callers may reset each to 0.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from topaz_tpu_torch.device import DeviceLike, resolve_device

# host data uploaded to a CUDA device through the staging ring, and its
# float32 bytes; host data uploaded to one the plain way (under
# STAGE_MIN_BYTES, non-contiguous, or not real numbers); device tensors
# fetched by to_host; raw frames read straight into a pool frame, raw frames
# read another way (not a one-section float32 MRC, or no frame at the
# bound), and pool frames allocated; in this process
staged_uploads = 0
staged_bytes = 0
plain_uploads = 0
pinned_fetches = 0
direct_reads = 0
fallback_reads = 0
allocations = 0
_lock = threading.Lock()  # the counters, from loader threads too, and _rings

# host data of at least this many float32 bytes goes through the ring
STAGE_MIN_BYTES = 1 << 20
# the ring of each CUDA device: SLOTS pinned float32 slots of SLOT_BYTES
SLOTS = 3
SLOT_BYTES = 16 << 20
# the fewest values a thread of a host cast copies
_PART = 1 << 16

_rings: Dict[torch.device, "StagingRing"] = {}


def _count(**deltas) -> None:
    g = globals()
    with _lock:
        for name, d in deltas.items():
            g[name] += d


class _Block:
    """A host tensor and the CUDA event recorded behind its last copy (None:
    no copy on a card has used it). ``fetch_later`` returns one."""

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.event = None

    def ready(self) -> bool:
        """Whether its last copy has finished; does not wait."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def result(self) -> torch.Tensor:
        """The host tensor, once its last copy has finished."""
        self.wait()
        return self.host

    def record(self, stream) -> None:
        """Mark the copy just issued on the CUDA ``stream`` as its last."""
        if self.event is None:
            self.event = torch.cuda.Event()
        self.event.record(stream)


class StagingRing:
    """Reused float32 host slots through which host data goes to a device,
    one slot-sized chunk at a time: each chunk is cast into a slot on the
    host, then copied to the device without waiting, so that the next
    chunk's host copy overlaps it. A slot is written again only after its
    last copy has finished. Pinned for a CUDA device; made once and kept,
    so its pinned memory is bounded whatever the data's size. One upload at
    a time holds the ring.

    A numpy chunk is cast by ``np.copyto`` split over ``threads`` threads
    (numpy lets go of the interpreter lock while it copies), as PyTorch
    splits a tensor's ``copy_`` over its own: one thread copies a few GB/s,
    well under a pinned copy's rate to the card."""

    def __init__(self, pinned: bool, slots: int = SLOTS, slot_bytes: int = SLOT_BYTES,
                 threads: Optional[int] = None):
        self.slots = [_Block(torch.empty(slot_bytes // 4, dtype=torch.float32,
                                         pin_memory=pinned))
                      for _ in range(slots)]
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
        n, step = dst.numel(), self.slots[0].host.numel()
        stream = torch.cuda.current_stream(out.device) if out.is_cuda else None
        with self._lock:
            for lo in range(0, n, step):
                hi = min(n, lo + step)
                i = self._next
                self._next = (i + 1) % len(self.slots)
                slot = self.slots[i]
                slot.wait()  # its last copy has left the slot
                if isinstance(flat, torch.Tensor):
                    slot.host[:hi - lo].copy_(flat[lo:hi])
                else:
                    self._cast(slot.host[:hi - lo].numpy(), flat[lo:hi])
                dst[lo:hi].copy_(slot.host[:hi - lo], non_blocking=stream is not None)
                if stream is not None:
                    slot.record(stream)


def staging_ring(device: torch.device) -> StagingRing:
    """The CUDA ``device``'s ring, made at its first use."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = torch.device("cuda", index)
    with _lock:
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


def count_read(direct: bool) -> None:
    _count(**{"direct_reads" if direct else "fallback_reads": 1})


def in_flight(batch_size: int, prefetch: int) -> int:
    """The raw frames one ``MicrographPipeline.process`` call can hold at
    once: the loader window (``batch_size * (prefetch + 1)``), the batch the
    producer is building, the prefetch queue's batches and the batch being
    dispatched."""
    return batch_size * (prefetch + 1 + 1 + max(1, prefetch) + 1)


class FramePool:
    """float32 host frames keyed by shape, pinned if ``pinned``, that
    outlive ``process()`` calls: a loader reads a raw frame into one, the
    dispatching thread uploads it and gives it back, and it is handed out
    again once its upload has finished. At most ``bound`` frames, idle or in
    use; at the bound a take that finds no ready frame of its shape drops an
    idle one of another shape, or returns None (the loader then reads into
    pageable memory: it never waits for a frame)."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.bound = 0
        self.frames = 0  # alive, idle or in use
        self._idle: Dict[Tuple[int, ...], List[_Block]] = defaultdict(list)
        self._lock = threading.Lock()

    def lease(self, bound: int) -> "Lease":
        """The frames of one ``process()`` call, which holds at most
        ``bound`` at once."""
        with self._lock:
            self.bound = bound
        return Lease(self)

    def idle(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._idle.values())

    def _take(self, shape: Tuple[int, ...]) -> Optional[_Block]:
        with self._lock:
            idle = self._idle[shape]
            for i, block in enumerate(idle):
                if block.ready():
                    return idle.pop(i)
            if self.frames >= self.bound and not self._drop_idle():
                return None
            self.frames += 1
        try:
            block = _Block(torch.empty(shape, dtype=torch.float32, pin_memory=self.pinned))
        except BaseException:
            with self._lock:
                self.frames -= 1
            raise
        _count(allocations=1)
        return block

    def _drop_idle(self) -> bool:
        """Drop one idle frame whose upload has finished; under the lock."""
        for idle in self._idle.values():
            for i, block in enumerate(idle):
                if block.ready():
                    del idle[i]
                    self.frames -= 1
                    return True
        return False

    def _give(self, block: _Block) -> None:
        with self._lock:
            if self.frames > self.bound:
                # a later call's bound is lower: the copy holds its own
                # reference to a pinned source, so the frame may go now
                self.frames -= 1
            else:
                self._idle[tuple(block.host.shape)].append(block)


class Lease:
    """The frames one ``process()`` call has taken. Each goes back once:
    from the dispatching thread after its upload, from a loader whose read
    failed, or at ``close`` when the call ends with frames still loaded."""

    def __init__(self, pool: FramePool):
        self.pool = pool
        self._out: Dict[int, _Block] = {}  # a frame's id -> its block
        self._lock = threading.Lock()

    def take(self, shape) -> Optional[torch.Tensor]:
        block = self.pool._take(tuple(int(s) for s in shape))
        if block is None:
            return None
        with self._lock:
            self._out[id(block.host)] = block
        return block.host

    def upload(self, r, device: torch.device) -> torch.Tensor:
        """A raw frame on ``device``: a frame of this lease by a copy that
        does not hold the host, with its event recorded behind it on a card;
        a pageable array as it stands."""
        if not isinstance(r, torch.Tensor):
            return torch.from_numpy(r).to(device)
        x = r.to(device, non_blocking=True)
        if x.is_cuda:
            with self._lock:
                block = self._out.get(id(r))
            if block is not None:
                block.record(torch.cuda.current_stream(x.device))
        return x

    def give(self, frame: torch.Tensor) -> None:
        """Hand ``frame`` back, to be handed out again once its newest
        upload has finished; a frame already given back, or not taken here,
        is left alone."""
        with self._lock:
            block = self._out.pop(id(frame), None)
        if block is not None:
            self.pool._give(block)

    def close(self) -> None:
        """Hand back every frame still out; call once no loader runs."""
        with self._lock:
            blocks, self._out = list(self._out.values()), {}
        for block in blocks:
            self.pool._give(block)


def _start_fetch(t: torch.Tensor):
    """A pinned buffer that ``t`` is copied into without waiting, and the stream."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stream = torch.cuda.current_stream(t.device)
    buf.copy_(t, non_blocking=True)
    return buf, stream


def fetch(*tensors):
    """Copy several device tensors to the host with one synchronisation.

    Every device-to-host copy is started non-blocking into a pinned host
    buffer on the stream that produced the tensor; then each stream used is
    synchronised once, and only then are the buffers read. Returns numpy
    arrays (their buffers go back to the allocator when dropped); ``None``,
    numpy arrays and CPU tensors pass through."""
    bufs, streams = [], {}
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            buf, stream = _start_fetch(t)
            streams[stream.cuda_stream] = stream
            bufs.append(buf)
        else:
            bufs.append(t)
    for stream in streams.values():
        stream.synchronize()
    return tuple(None if b is None else b.numpy() if isinstance(b, torch.Tensor)
                 else np.asarray(b) for b in bufs)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``fetch`` of one tensor: a pinned buffer, or a CPU tensor's memory."""
    if t.is_cuda:
        _count(pinned_fetches=1)
    return fetch(t)[0]


def fetch_later(t: torch.Tensor) -> _Block:
    """Start copying ``t`` to the host without waiting: a CUDA tensor into a
    pinned buffer, with an event behind the copy; ``result()`` waits for it.
    A CPU tensor is its own result."""
    if not t.is_cuda:
        return _Block(t)
    buf, stream = _start_fetch(t)
    block = _Block(buf)
    block.record(stream)
    return block
