"""The spill tier's two queue walks, repaired: the port's spill victim index
and its sorted snapshot of the Python queue, against the JAX package's
whole-queue scans.

``Server._maybe_spill`` of the JAX package picks its victims by
``heapq.nsmallest(64, ...)`` over every unit of the queue on each put above
the spill watermark; the port pops them from a resident index
(``runtime/spill.py`` ``SpillIndex``, kept by ``PartitionedWorkQueue``). On
a seeded run of puts above the watermark, consumes, pins, unpins, fault-ins
and job kills, both methods run on the same queue, and the JAX package's
own ``_maybe_spill`` (made to record instead of spill) names the victims
the port's must spill, in the same order. A put above the watermark reads
no unit outside its victims and never walks the queue. Exact equality: the
victims are units.

The spill tier forces the Python queue, whose balancer snapshot the JAX
package takes by ``heapq.nsmallest(K, ...)`` over every unit on each
snapshot (``Server._send_snapshot``); the port's ``WorkQueue`` keeps its
available units sorted once asked (``snapshot_untargeted``), and its
snapshot equals that walk's and the C++ queue core's on a seeded run of
adds, pins, unpins and removes.
"""

import types

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

import heapq

from adlb_tpu.runtime.queues import WorkUnit as RefWorkUnit
from adlb_tpu.runtime.server import Server as RefServer
from adlb_tpu_torch.runtime import spill
from adlb_tpu_torch.runtime.queues import (
    MemoryAccountant, PartitionedWorkQueue, WorkQueue, WorkUnit)
from adlb_tpu_torch.runtime.server import Server

#: the unit fields either method may read
FIELDS = {"payload", "pinned", "spilled", "time_stamp", "seqno", "spill_len"}


class TrackedUnit(WorkUnit):
    """A unit that records whose fields are read while ``touched`` is set."""

    touched = None

    def __getattribute__(self, name):
        seen = TrackedUnit.touched
        if seen is not None and name in FIELDS:
            seen.add(object.__getattribute__(self, "seqno"))
        return object.__getattribute__(self, name)


class _Counter:
    def inc(self, n=1):
        pass

    def observe(self, v):
        pass


def _servers(tmp_path, cap):
    """A port server's spill state (its own methods bound to a namespace)
    and the JAX package's scan over the same queue, recording its picks."""
    wq = PartitionedWorkQueue(WorkQueue)
    wq.spill_index = spill.SpillIndex()
    state = dict(wq=wq, mem=MemoryAccountant(cap, soft_frac=0.5),
                 cfg=types.SimpleNamespace(spill_watermark_frac=0.5),
                 spill=spill.SpillStore(str(tmp_path), 0),
                 _m_spills=_Counter(), _m_faultins=_Counter(),
                 _h_faultin=_Counter())
    port = types.SimpleNamespace(**state)
    for name in ("_maybe_spill", "_unspill"):
        setattr(port, name, types.MethodType(getattr(Server, name), port))
    spilled = []
    real_spill = types.MethodType(Server._spill_unit, port)

    def spill_unit(u):
        spilled.append(u.seqno)
        real_spill(u)

    port._spill_unit = spill_unit
    picks = []
    ref = types.SimpleNamespace(**state, _spill_unit=picks.append)
    ref._maybe_spill = types.MethodType(RefServer._maybe_spill, ref)
    return port, ref, picks, spilled


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_victims_equal_the_whole_queue_scan(seed, tmp_path,
                                                  monkeypatch):
    rng = np.random.default_rng(seed)
    cap = 40_000
    port, ref, picks, spilled = _servers(tmp_path, cap)
    wq, mem = port.wq, port.mem
    clock = [0.0]
    seq = [0]
    puts_over = victims_total = 0

    def scan_units():
        raise AssertionError("a put above the watermark walked the queue")

    for step in range(600):
        op = rng.random()
        queued = list(wq.units())
        if op < 0.55 or not queued:
            # a put: ties in size and in time stamp are common, so the
            # order's later keys decide
            seq[0] += 1
            if rng.random() < 0.7:
                clock[0] += 1.0
            n = int(rng.choice([0, 64, 64, 128, 256, 1024, 2048]))
            unit = TrackedUnit(seqno=seq[0], work_type=1, prio=0,
                               target_rank=-1, answer_rank=0,
                               payload=rng.bytes(n),
                               time_stamp=clock[0],
                               job=int(rng.random() < 0.2))
            picks.clear()
            spilled.clear()
            ref._maybe_spill(n)
            want = [u.seqno for u in picks]
            before = {u.seqno for u in queued if u.spilled}
            TrackedUnit.touched = set()
            monkeypatch.setattr(wq, "units", scan_units)
            try:
                port._maybe_spill(n)
            finally:
                touched, TrackedUnit.touched = TrackedUnit.touched, None
                monkeypatch.undo()
            # the JAX package's victims, in its order, and nothing else
            assert spilled == want, step
            assert {u.seqno for u in wq.units() if u.spilled} - before \
                == set(want), step
            assert touched <= set(want), (step, touched - set(want))
            if want:
                puts_over += 1
                victims_total += len(want)
            mem.alloc(n)
            wq.add(unit)
        else:
            u = queued[int(rng.integers(len(queued)))]
            if op < 0.70:
                # consumed: faulted in if spilled, then removed
                port._unspill(u)
                if not u.pinned:
                    wq.pin(u.seqno, 3)
                wq.remove(u.seqno)
                mem.free(len(u.payload))
            elif op < 0.82:
                if u.pinned:
                    wq.unpin(u.seqno)
                else:
                    port._unspill(u)  # a reserve faults the payload in
                    wq.pin(u.seqno, 4)
            elif op < 0.97:
                port._unspill(u)  # a fault-in that leaves it queued
            else:
                # a killed job drops its partition wholesale
                for d in wq.drop_job(1):
                    if d.spilled:
                        mem.note_spill_drop(port.spill.discard(d.seqno))
                    else:
                        mem.free(len(d.payload))
    assert puts_over > 50 and victims_total > puts_over
    # the index holds exactly the units the scan would consider
    eligible = {u.seqno for u in wq.units()
                if not u.pinned and not u.spilled and len(u.payload) > 0}
    assert len(wq.spill_index) == len(eligible)
    port.spill.close()


def test_index_pops_in_scan_order_and_drops_stale_entries():
    index = spill.SpillIndex()
    units = [WorkUnit(seqno=s, work_type=1, prio=0, target_rank=-1,
                      answer_rank=0, payload=b"x" * n, time_stamp=ts)
             for s, n, ts in ((1, 10, 5.0), (2, 30, 7.0), (3, 30, 6.0),
                              (4, 10, 5.0), (5, 0, 1.0))]
    for u in units:
        index.offer(u)
    assert len(index) == 4  # an empty payload is never a victim
    units[2].pinned = True
    index.offer(units[2])  # pinned: out
    units[2].pinned = False
    index.offer(units[2])  # unpinned: back, one heap entry live
    index.offer(units[2])
    index.discard(4)
    assert [index.pop().seqno for _ in range(3)] == [3, 2, 1]
    assert index.pop() is None and len(index) == 0


def _walk(units, K):
    """The JAX package's snapshot walk (``Server._send_snapshot`` on a
    Python queue), over the given units."""
    tasks = heapq.nsmallest(
        K,
        ((-u.prio, u.seqno, u.work_type, u.payload_len) for u in units
         if not u.pinned and u.target_rank < 0 and getattr(u, "job", 0) == 0))
    return [(s, t, -np_, ln) for np_, s, t, ln in tasks]


@pytest.mark.parametrize("seed,K", [(0, 16), (1, 300), (2, 4096)])
def test_snapshot_equals_the_whole_queue_walk_and_the_native_core(seed, K):
    try:
        from adlb_tpu_torch.native.wq import NativeWorkQueue

        native = NativeWorkQueue()
    except (RuntimeError, OSError, ImportError):
        native = None  # no compiler here: the walk alone is the oracle
    rng = np.random.default_rng(seed)
    wq = PartitionedWorkQueue(WorkQueue)
    ref_units = {}
    seq = 0
    snaps = 0
    for step in range(3000):
        op = rng.random()
        queued = list(wq.units())
        if op < 0.5 or not queued:
            seq += 1
            kw = dict(seqno=seq, work_type=int(rng.integers(1, 4)),
                      prio=int(rng.integers(-3, 4)),
                      target_rank=int(rng.choice([-1, -1, -1, 2])),
                      answer_rank=0, payload=rng.bytes(int(rng.integers(9))))
            wq.add(WorkUnit(**kw))
            ref_units[seq] = RefWorkUnit(**kw)
            if native is not None:
                native.add(WorkUnit(**kw))
        else:
            u = queued[int(rng.integers(len(queued)))]
            if op < 0.7:
                wq.remove(u.seqno)
                del ref_units[u.seqno]
                if native is not None:
                    native.remove(u.seqno)
            elif u.pinned:
                wq.unpin(u.seqno)
                ref_units[u.seqno].pinned = False
                if native is not None:
                    native.unpin(u.seqno)
            else:
                wq.pin(u.seqno, 5)
                ref_units[u.seqno].pinned = True
                if native is not None:
                    native.pin(u.seqno, 5)
        if step % 50 == 0 or step > 2950:
            got = wq.snapshot_untargeted(K)
            assert got == _walk(ref_units.values(), K), step
            if native is not None:
                assert got == native.snapshot_untargeted(K), step
            snaps += 1
    assert snaps > 60 and len(wq.snapshot_untargeted(K)) > 0


def test_sorted_keys_split_and_drain():
    from adlb_tpu_torch.runtime.queues import _SortedKeys

    rng = np.random.default_rng(3)
    keys = _SortedKeys([])
    want = set()
    for k in rng.permutation(5000).tolist():
        keys.add((k % 7, k))
        want.add((k % 7, k))
    assert len(keys._b) > 4  # buckets split past 2 * LOAD
    for k in rng.permutation(5000)[:4000].tolist():
        keys.discard((k % 7, k))
        want.discard((k % 7, k))
    keys.discard((99, 99))  # absent: no effect
    assert keys.first(10**6) == sorted(want)
    assert keys.first(5) == sorted(want)[:5]
