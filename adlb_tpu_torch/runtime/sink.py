"""Swappable line sink shared by the observability modules (stats, debug).

Each module owns its own :class:`Sink` instance so tests can capture one
stream without touching the other; the default destination is stderr, like
the reference's aprintf output."""

from __future__ import annotations

import sys
from typing import Callable, Optional


class Sink:
    def __init__(self) -> None:
        self._fn: Optional[Callable[[str], None]] = None

    def set(self, fn: Optional[Callable[[str], None]]) -> None:
        """Redirect output (tests); None restores stderr."""
        self._fn = fn

    def emit(self, line: str) -> None:
        if self._fn is not None:
            self._fn(line)
        else:
            print(line, file=sys.stderr, flush=True)
