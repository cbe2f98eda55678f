"""Prefetch-window loading (port of ``window_batches`` from
topaz_tpu/utils/batching.py): loader threads keep the next few files read
while the device works on the current one."""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple


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
