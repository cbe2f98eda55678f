"""Shape buckets and prefetch loading (port of topaz_tpu/utils/batching.py).

The batched pipelines (pipeline.MicrographPipeline and
preprocess.normalize_images_batched) zero-pad each micrograph up to a
rounded shape bucket, mask device statistics to the valid region, and keep
the device fed with loader threads. This module holds those pieces so that
they cannot drift between the two.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence, Tuple

import torch

_SENTINEL = object()


def round_bucket(shape: Sequence[int], step: int) -> Tuple[int, ...]:
    """Round every extent of ``shape`` up to the next multiple of ``step``."""
    return tuple(-(-int(s) // step) * step for s in shape)


def valid_mask(bucket: Sequence[int], valid: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the valid (unpadded) region of a bucket batch.

    ``bucket`` is the padded shape; ``valid`` is a ``(B, ndim)`` integer
    tensor of the true extents. Returns a ``(B, *bucket)`` bool tensor on
    ``valid``'s device, True where the pixel belongs to the real image."""
    B = valid.shape[0]
    ndim = len(bucket)
    mask = None
    for d, extent in enumerate(bucket):
        idx = torch.arange(extent, device=valid.device).reshape(
            (1,) + (1,) * d + (extent,) + (1,) * (ndim - d - 1))
        m = idx < valid[:, d].reshape((B,) + (1,) * ndim)
        mask = m if mask is None else (mask & m)
    return mask


class _ProducerError:
    """Wraps an exception raised in the producer thread so it can cross the
    queue unambiguously (a raw exception instance could be a legal item)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def iterate_prefetched(gen, maxsize: int = 2) -> Iterator:
    """Drain ``gen`` in a background daemon thread through a bounded queue.

    Items are yielded in order; an exception raised in the producer
    re-raises in the consumer instead of hanging it; the end-of-stream
    sentinel cannot collide with a real item. ``maxsize`` bounds host-RAM
    buffering (clamped to at least one slot). ``gen`` may be an iterable or
    a zero-argument callable returning one (the callable form runs any
    pre-iteration work in the producer thread).

    A consumer that stops early (closes or drops this generator) stops the
    producer too: its next put gives up, ``gen`` is closed in its thread
    (so loader pools it holds shut down), and the consumer joins it, so no
    thread is left blocked on a full queue holding loaded batches."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        it = None
        try:
            it = gen() if callable(gen) else gen
            for item in it:
                if not put(item):
                    return
            put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - propagated to the consumer
            put(_ProducerError(e))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    producer = threading.Thread(target=run, daemon=True)
    producer.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        producer.join(timeout=60)


def window_batches(
    items: List,
    load_one: Callable,
    batch_size: int,
    window: int,
    num_workers: int = 2,
) -> Iterator[Tuple[List, int, List]]:
    """Yield prefetch-loaded batches of ``items``.

    A ``num_workers``-thread pool keeps up to ``window`` ``load_one(item)``
    futures in flight ahead of the consumer. Yields
    ``(chunk, n_real, loaded)`` per batch where ``chunk`` are the original
    items, ``n_real = len(chunk)``, and ``loaded`` is padded to exactly
    ``batch_size`` entries by repeating the last loaded value.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    window = max(window, batch_size)
    with ThreadPoolExecutor(max(1, num_workers)) as ex:
        futs: "deque" = deque()
        nxt = 0

        def fill(n: int) -> int:
            while n < len(items) and len(futs) < window:
                futs.append(ex.submit(load_one, items[n]))
                n += 1
            return n

        nxt = fill(nxt)
        for start in range(0, len(items), batch_size):
            chunk = items[start : start + batch_size]
            loaded = []
            for _ in range(len(chunk)):
                loaded.append(futs.popleft().result())
                nxt = fill(nxt)
            n_real = len(loaded)
            while len(loaded) < batch_size:
                loaded.append(loaded[-1])
            yield chunk, n_real, loaded


class _LoadFailure:
    def __init__(self, exc: Exception):
        self.exc = exc


def load_batches(
    items: List,
    load_one: Callable,
    batch_size: int,
    window: int,
    num_workers: int = 2,
    skip_errors: bool = False,
    label: Callable = str,
) -> Iterator[Tuple[List, List]]:
    """``window_batches`` for the batched pipelines: yields
    ``(chunk, loaded)``, ``loaded`` padded to ``batch_size`` by repeating
    its last entry. With ``skip_errors`` an item whose load raises is left
    out with a warning naming ``label(item)``, and a batch left with nothing
    is skipped (the reference fails on the first bad file, and so does this
    without ``skip_errors``)."""
    import warnings

    def load(item):
        if not skip_errors:
            return load_one(item)
        try:
            return load_one(item)
        except Exception as e:  # noqa: BLE001 - skipped with a warning
            return _LoadFailure(e)

    for chunk, _, loaded in window_batches(items, load, batch_size, window,
                                           num_workers=num_workers):
        kept = []
        for item, value in zip(chunk, loaded):
            if isinstance(value, _LoadFailure):
                warnings.warn(f"{label(item)}: {value.exc} — skipped (--skip-errors)")
            else:
                kept.append((item, value))
        if not kept:
            continue
        if len(kept) < len(chunk):
            chunk = [item for item, _ in kept]
            loaded = [value for _, value in kept]
            loaded += [loaded[-1]] * (batch_size - len(loaded))
        yield chunk, loaded
