"""partest — synthetic-work calibration utility.

Mirrors the reference ``examples/partest.c``: ``define_work(secs)`` runs a
triply-nested loop over an indivisible ``nugget()`` (a short fixed burst of
floating-point work, reference ``examples/partest.c:115-123``) under a clock
until ``secs`` have elapsed, returning the loop indices ``(i, j, k)`` reached;
``do_work(i, j, k)`` replays those indices without consulting the clock, so
the replay takes (approximately) the calibrated wall time on a same-speed
machine. The reference uses this to parameterize synthetic workloads (skel /
c2 style "work that takes N seconds") portably across machines; its main()
then replays the unit on every rank and reports the parallel speedup.

The pure-Python nugget here is far slower per call than the C one, so the
loop limit is kept but the indices come out smaller; the contract — replay
time tracks calibration time — is what the tests check.
"""

from __future__ import annotations

import dataclasses
import math
import time

LOOPLIMIT = 100_000  # reference examples/partest.c:12


def nugget(_reps: int = 1000) -> float:
    """The indivisible unit of work (reference examples/partest.c:115-123)."""
    x = 0.0
    for i in range(_reps):
        x = math.sqrt(math.sqrt(math.sqrt(float(i)) + math.sqrt(float(i + 1))))
        x = math.sqrt(math.sqrt(math.sqrt(float(i + 2)) + math.sqrt(float(i + 3))))
    return x


@dataclasses.dataclass
class WorkUnit:
    """A calibrated synthetic work unit: replaying (i, j, k) nuggets takes
    roughly the wall time passed to define_work."""

    i: int
    j: int
    k: int
    calibrated_secs: float


def define_work(secs: float, nugget_reps: int = 1000) -> WorkUnit:
    """Run nuggets under the clock until `secs` elapse; record the indices
    (reference examples/partest.c:69-90)."""
    start = time.perf_counter()
    i = j = k = 0
    done = False
    for i in range(LOOPLIMIT):
        for j in range(LOOPLIMIT):
            for k in range(LOOPLIMIT):
                nugget(nugget_reps)
                if time.perf_counter() - start >= secs:
                    done = True
                    break
            if done:
                break
        if done:
            break
    return WorkUnit(i=i, j=j, k=k, calibrated_secs=secs)


def do_work(unit: WorkUnit, nugget_reps: int = 1000) -> float:
    """Replay a calibrated unit without the clock; returns elapsed seconds
    (reference examples/partest.c:92-112)."""
    start = time.perf_counter()
    for _ in range(unit.i + 1):
        for _ in range(unit.j + 1):
            for _ in range(unit.k + 1):
                nugget(nugget_reps)
    return time.perf_counter() - start
