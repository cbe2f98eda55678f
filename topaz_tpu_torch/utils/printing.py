"""stderr progress reporting, matching the reference's '#'-prefixed lines
(topaz/utils/printing.py:5-6)."""

from __future__ import annotations

import sys


def report(*args, **kwargs) -> None:
    print("#", *args, file=sys.stderr, **kwargs)
