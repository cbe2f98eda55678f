"""Reused host frames for the batched pipeline's raw micrographs.

A loader thread of ``MicrographPipeline.process`` reads a raw frame
straight into a frame of the pipeline's ``FramePool``
(``io/mrc.readinto``); the dispatching thread uploads from it and gives
it back. Frames are pinned where the pipeline runs on a CUDA device, so
the upload is a DMA that does not hold the host, and plain host tensors
elsewhere. Frames outlive ``process()`` calls, so a warm pass allocates
none.

A frame goes back only after its upload: it comes with the event recorded
behind its copy, and is handed out again once that event has completed.
The pool holds at most ``bound`` frames, idle or in use. At the bound, a
take that finds no ready frame of its shape drops an idle frame of another
shape, or returns None, and the loader reads into pageable memory as the
pipeline did before the pool: a loader never waits for a frame.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# raw frames the loaders read straight into a pool frame, raw frames read
# another way (not a one-section float32 MRC, or no frame at the bound),
# and pool frames allocated, in this process; callers may reset each to 0
direct_reads = 0
fallback_reads = 0
allocations = 0
# the loader threads count from threads of their own
_lock = threading.Lock()


def count_read(direct: bool) -> None:
    global direct_reads, fallback_reads
    with _lock:
        if direct:
            direct_reads += 1
        else:
            fallback_reads += 1


def in_flight(batch_size: int, prefetch: int) -> int:
    """The raw frames one ``process()`` call can hold at once: the loader
    window (``batch_size * (prefetch + 1)``), the batch the producer is
    building, the prefetch queue's batches and the batch being dispatched."""
    return batch_size * (prefetch + 1 + 1 + max(1, prefetch) + 1)


def _ready(event) -> bool:
    return event is None or event.query()


class FramePool:
    """float32 host frames keyed by shape, pinned if ``pinned``."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.bound = 0
        self.frames = 0  # alive, idle or in use
        self._idle: Dict[Tuple[int, ...], List] = defaultdict(list)  # shape -> [(frame, event)]
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

    def _take(self, shape: Tuple[int, ...]) -> Optional[torch.Tensor]:
        global allocations
        with self._lock:
            idle = self._idle[shape]
            for i, (frame, event) in enumerate(idle):
                if _ready(event):
                    del idle[i]
                    return frame
            if self.frames >= self.bound and not self._drop_idle():
                return None
            self.frames += 1
        try:
            frame = torch.empty(shape, dtype=torch.float32, pin_memory=self.pinned)
        except BaseException:
            with self._lock:
                self.frames -= 1
            raise
        with _lock:
            allocations += 1
        return frame

    def _drop_idle(self) -> bool:
        """Drop one idle frame whose upload has finished; under the lock."""
        for idle in self._idle.values():
            for i, (_, event) in enumerate(idle):
                if _ready(event):
                    del idle[i]
                    self.frames -= 1
                    return True
        return False

    def _give(self, frame: torch.Tensor, event) -> None:
        with self._lock:
            if self.frames > self.bound:
                # a later call's bound is lower: the copy holds its own
                # reference to a pinned source, so the frame may go now
                self.frames -= 1
            else:
                self._idle[tuple(frame.shape)].append((frame, event))


class Lease:
    """The frames one ``process()`` call has taken. Each goes back once:
    from the dispatching thread after its upload, from a loader whose read
    failed, or at ``close`` when the call ends with frames still loaded."""

    def __init__(self, pool: FramePool):
        self.pool = pool
        self._out: Dict[int, torch.Tensor] = {}
        self._lock = threading.Lock()

    def take(self, shape) -> Optional[torch.Tensor]:
        frame = self.pool._take(tuple(int(s) for s in shape))
        if frame is not None:
            with self._lock:
                self._out[id(frame)] = frame
        return frame

    def give(self, frame: torch.Tensor, event=None) -> None:
        """Hand ``frame`` back once ``event`` (None: now) has completed; a
        frame already given back, or not taken here, is left alone."""
        with self._lock:
            if self._out.pop(id(frame), None) is None:
                return
        self.pool._give(frame, event)

    def close(self) -> None:
        """Hand back every frame still out; call once no loader runs."""
        with self._lock:
            frames = list(self._out.values())
            self._out.clear()
        for frame in frames:
            self.pool._give(frame, None)
