"""Transient device-failure detection and bounded retry (port of
topaz_tpu/utils/retry.py).

A dropped transport or a device briefly held by a dying predecessor is
worth a retry; a program error is not. The failures reach Python as
generic ``RuntimeError``s whose message carries the cause, so the
classification reads the message, with the same markers and backoff as the
JAX package.

Never transient, besides the JAX package's permanent markers: device
memory exhaustion (``torch.cuda.OutOfMemoryError``: the identical call
cannot fit the second time), and CUDA's sticky errors (an illegal memory
access, a device-side assert, a launch failure), after which the CUDA
context is unusable for the rest of the process.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, TypeVar

import torch

T = TypeVar("T")

_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "connection refused",
    "connection closed",
    "socket closed",
    "broken pipe",
    "failed to connect",
    "transport",
    "temporarily unavailable",
    "try again",
    "already claimed",
    "device grant",
)

_PERMANENT_MARKERS = (
    "Ran out of memory",
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "INVALID_ARGUMENT",
    "NOT_FOUND",
    "UNIMPLEMENTED",
    # CUDA: the allocator's message, and the sticky errors
    "out of memory",
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
)


def is_transient_device_error(e: BaseException) -> bool:
    """True when retrying the same call might succeed (transport or device
    grant weather), False for program errors, OOM and sticky CUDA errors."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(e, (ConnectionError, TimeoutError)):
        return True
    msg = str(e)
    if any(m in msg for m in _PERMANENT_MARKERS):
        return False
    low = msg.lower()
    return any(m.lower() in low for m in _TRANSIENT_MARKERS)


def retry_transient(fn: Callable[[], T], retries: int = 1,
                    base_delay: float = 2.0,
                    what: str = "device call") -> T:
    """Run ``fn``; on a transient failure, warn and retry up to ``retries``
    times with exponential backoff. Other errors and the last transient
    failure propagate unchanged."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - filtered to transient below
            if attempt >= retries or not is_transient_device_error(e):
                raise
            delay = base_delay * (2 ** attempt)
            print(f"# WARNING: {what} failed with a transient device error "
                  f"({type(e).__name__}: {e}); retrying in {delay:g}s "
                  f"(attempt {attempt + 2}/{retries + 1})",
                  file=sys.stderr, flush=True)
            time.sleep(delay)
    raise AssertionError("unreachable")
