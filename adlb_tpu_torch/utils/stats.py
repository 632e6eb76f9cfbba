"""Incremental running statistics.

Port of the reference's standalone stats library (reference
``examples/stats.c``): values are contributed one at a time and running
min / max / mean / sample standard deviation stay current after every
contribution, using the numerically stable incremental update from Higham,
*Accuracy and Stability of Numerical Algorithms*, pp. 12-13 (the same
algorithm the reference cites, ``examples/stats.c:1-9``). Used by the
coinop workload's worker-side pop-latency accumulation.
"""

from __future__ import annotations

import math


class RunningStats:
    """Streaming min/max/mean/stddev accumulator with an on/off gate.

    Mirrors the reference object: ``statsinit/statson/statsoff/statsreset/
    statsenter`` plus accessors (reference ``examples/stats.c:30-52``).
    Contributions while the gate is off are ignored, as in the reference
    (``examples/stats.c:main`` demonstrates this contract).
    """

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.active = False
        self.reset()

    def reset(self) -> None:
        """Reinitialize without losing the name (reference ``statsreset``).
        Also turns the gate off, matching ``statsinit``'s initial state."""
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._mean = 0.0
        self._q = 0.0  # sum of squared deviations (Higham's running Q)
        self.numvals = 0
        self.active = False

    def on(self) -> None:
        self.active = True

    def off(self) -> None:
        self.active = False

    def enter(self, value: float) -> bool:
        """Contribute one value; returns False if the gate is off."""
        if not self.active:
            return False
        self.numvals += 1
        n = self.numvals
        self._sum += value
        if value < self._min:
            self._min = value
        if value > self._max:
            self._max = value
        delta = value - self._mean
        self._mean += delta / n
        self._q += delta * (value - self._mean)
        return True

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self.numvals else 0.0

    @property
    def max(self) -> float:
        return self._max if self.numvals else 0.0

    @property
    def mean(self) -> float:
        return self._mean if self.numvals else 0.0

    @property
    def stddev(self) -> float:
        """Sample standard deviation (n-1 denominator, as the reference)."""
        if self.numvals < 2:
            return 0.0
        return math.sqrt(self._q / (self.numvals - 1))

    def dump(self) -> str:
        return (
            f"stats[{self.name}]: n={self.numvals} sum={self._sum:.6g} "
            f"min={self.min:.6g} max={self.max:.6g} mean={self.mean:.6g} "
            f"stddev={self.stddev:.6g} active={int(self.active)}"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{self.dump()}>"


_rss_cache: list = [0.0, 0]  # [stamp, value]


def rss_kb(max_age: float = 1.0) -> int:
    """Resident-set size of this process in KiB, from /proc/self/status —
    the reference's get_memusage probe (reference ``src/adlb.c:3347-3369``).
    Cached for ``max_age`` seconds: callers on periodic paths (the qmstat
    entry at 20 Hz) must not pay a /proc read per tick. Returns 0 where
    /proc is unavailable (non-Linux)."""
    import time as _time

    now = _time.monotonic()
    if now - _rss_cache[0] < max_age and _rss_cache[1]:
        return _rss_cache[1]
    val = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    val = int(line.split()[1])
                    break
    except OSError:
        pass
    _rss_cache[0] = now
    _rss_cache[1] = val
    return val
