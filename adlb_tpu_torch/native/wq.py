"""ctypes wrapper: a WorkQueue with the matching index in C++.

Drop-in for :class:`adlb_tpu_torch.runtime.queues.WorkQueue` (same method surface,
property-tested for identical behavior). Python keeps the authoritative
unit table — payload bytes and full metadata for protocol responses — while
the C++ side maintains the match index and answers the hot queries
(find_match, qmstat cells, balancer snapshots) without touching Python
objects per candidate.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Optional

from adlb_tpu_torch.runtime.queues import WorkUnit
from adlb_tpu_torch.types import ADLB_LOWEST_PRIO


def _types_array(req_types: Optional[frozenset[int]]):
    if req_types is None:
        return None, 0
    n = len(req_types)
    arr = (ctypes.c_int32 * n)(*sorted(req_types))
    return arr, n


class NativeWorkQueue:
    def __init__(self) -> None:
        from adlb_tpu_torch.native.build import ensure_built

        self._lib = ensure_built()
        if self._lib is None:
            from adlb_tpu_torch.native.build import build_error

            raise RuntimeError(build_error() or "native core unavailable")
        self._h = self._lib.adlb_wq_new()
        self._units: dict[int, WorkUnit] = {}

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.adlb_wq_free(h)

    # -- insertion / removal -------------------------------------------------

    def add(self, unit: WorkUnit) -> None:
        rc = self._lib.adlb_wq_add(
            self._h,
            unit.seqno,
            unit.work_type,
            unit.prio,
            unit.target_rank,
            1 if unit.pinned else 0,
            unit.pin_rank,
            len(unit.payload),
        )
        assert rc == 0, f"duplicate seqno {unit.seqno}"
        self._units[unit.seqno] = unit

    def get(self, seqno: int) -> Optional[WorkUnit]:
        return self._units.get(seqno)

    def remove(self, seqno: int) -> WorkUnit:
        unit = self._units.pop(seqno)
        self._lib.adlb_wq_remove(self._h, seqno)
        return unit

    # -- pin discipline ------------------------------------------------------

    def pin(self, seqno: int, rank: int) -> None:
        unit = self._units[seqno]
        unit.pinned = True
        unit.pin_rank = rank
        self._lib.adlb_wq_pin(self._h, seqno, rank)

    def unpin(self, seqno: int) -> None:
        unit = self._units[seqno]
        unit.pinned = False
        unit.pin_rank = -1
        self._lib.adlb_wq_unpin(self._h, seqno)

    # -- matching ------------------------------------------------------------

    def _by_seqno(self, seqno: int) -> Optional[WorkUnit]:
        return None if seqno < 0 else self._units[seqno]

    def find_match(
        self, rank: int, req_types: Optional[frozenset[int]]
    ) -> Optional[WorkUnit]:
        arr, n = _types_array(req_types)
        return self._by_seqno(
            self._lib.adlb_wq_find_match(self._h, rank, arr, n)
        )

    def find_targeted(
        self, rank: int, req_types: Optional[frozenset[int]]
    ) -> Optional[WorkUnit]:
        arr, n = _types_array(req_types)
        return self._by_seqno(
            self._lib.adlb_wq_find_targeted(self._h, rank, arr, n)
        )

    def find_untargeted(
        self, req_types: Optional[frozenset[int]]
    ) -> Optional[WorkUnit]:
        arr, n = _types_array(req_types)
        return self._by_seqno(
            self._lib.adlb_wq_find_untargeted(self._h, arr, n)
        )

    def find_unpinned(self) -> Optional[WorkUnit]:
        worst: Optional[WorkUnit] = None
        for u in self._units.values():
            if u.pinned:
                continue
            if u.target_rank < 0 and (worst is None or u.prio < worst.prio):
                worst = u
        if worst is not None:
            return worst
        for u in self._units.values():
            if not u.pinned:
                return u
        return None

    # -- stats ---------------------------------------------------------------

    def num_unpinned(self) -> int:
        return self._lib.adlb_wq_num_unpinned(self._h)

    def num_unpinned_untargeted(self) -> int:
        return self._lib.adlb_wq_num_unpinned_untargeted(self._h)

    # availability signal for the balancer's snapshot gating (the Python
    # queue keeps an O(1) counter; the C core's count is cheap per tick)
    untargeted_avail = property(num_unpinned_untargeted)

    def hi_prio_of_type(self, work_type: int) -> int:
        out = ctypes.c_int32()
        rc = self._lib.adlb_wq_hi_prio_of_type(
            self._h, work_type, ctypes.byref(out)
        )
        return out.value if rc == 0 else ADLB_LOWEST_PRIO

    def count_of_type(self, work_type: int) -> tuple[int, int]:
        n = 0
        nbytes = 0
        for u in self._units.values():
            if u.work_type == work_type:
                n += 1
                nbytes += u.work_len
        return n, nbytes

    def snapshot_untargeted(self, cap: int) -> list[tuple[int, int, int, int]]:
        """Top-`cap` available units by priority — (seqno, type, prio, len);
        the balancer snapshot fast path, sorted in C++."""
        seqnos = (ctypes.c_int64 * cap)()
        types = (ctypes.c_int32 * cap)()
        prios = (ctypes.c_int32 * cap)()
        lens = (ctypes.c_int64 * cap)()
        n = self._lib.adlb_wq_snapshot_untargeted(
            self._h, cap, seqnos, types, prios, lens
        )
        return [
            (seqnos[i], types[i], prios[i], lens[i]) for i in range(n)
        ]

    def units(self) -> Iterable[WorkUnit]:
        return self._units.values()

    @property
    def count(self) -> int:
        return self._lib.adlb_wq_count(self._h)

    @property
    def max_count(self) -> int:
        return self._lib.adlb_wq_max_count(self._h)

    @property
    def total_bytes(self) -> int:
        return self._lib.adlb_wq_total_bytes(self._h)

    def depth_sample(self) -> tuple[int, int, int]:
        """(count, unpinned-untargeted, bytes) — the periodic
        observability tick's queue-depth gauges (twin of the Python
        WorkQueue's depth_sample). ONE C call: every ctypes crossing
        releases and re-acquires the GIL, and on a loaded host each
        re-acquire can stall the reactor thread for milliseconds — the
        old three-property version was a measurable slice of tpu-mode
        pop latency."""
        out = (ctypes.c_int64 * 3)()
        self._lib.adlb_wq_depth_sample(self._h, out)
        return out[0], out[1], out[2]
