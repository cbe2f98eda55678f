"""Prefetch loading (port of ``window_batches`` and ``iterate_prefetched``
from topaz_tpu/utils/batching.py): loader threads keep the next few files
read while the device works on the current one."""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

_SENTINEL = object()


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
    pre-iteration work in the producer thread)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))

    def run():
        try:
            for item in (gen() if callable(gen) else gen):
                q.put(item)
            q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - propagated to the consumer
            q.put(_ProducerError(e))

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, _ProducerError):
            raise item.exc
        yield item


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
