"""SIGTERM handling for the long-running service commands (port of
topaz_tpu/utils/signals.py).

``watch`` and ``serve`` run under process managers (systemd, k8s, SLURM)
whose stop path is SIGTERM, which by default kills Python without running
``finally`` blocks and so skips the manifest flush and the server close
that the KeyboardInterrupt (^C) path performs. This context manager makes
SIGTERM raise KeyboardInterrupt in the main thread, so both stop signals
share one orderly shutdown.
"""

from __future__ import annotations

import contextlib
import signal
import threading


@contextlib.contextmanager
def sigterm_as_interrupt():
    """Within the block, SIGTERM raises KeyboardInterrupt (main thread
    only: signal handlers cannot be installed elsewhere, so use in another
    thread is a no-op). The previous handler is restored on exit."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _raise(signum, frame):
        raise KeyboardInterrupt

    try:
        prev = signal.signal(signal.SIGTERM, _raise)
    except ValueError:  # e.g. signals not supported in this interpreter
        yield
        return
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)
