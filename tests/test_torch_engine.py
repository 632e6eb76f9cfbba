"""PlanEngine rounds: the port against the JAX package on one scripted
snapshot sequence.

Both engines see the same seeded sequence of snapshot dicts (full
restamps, in-place task deltas, dead-rank requester patches, server death
and rejoin, and the plans of the previous round consumed) and must return
identical ``(matches, migrations)`` every round. The wall-clock windows
are pinned to extremes, as tests/test_ledger_parity.py does, because the
two engines run one after the other.
"""

import copy
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.balancer.engine import PlanEngine as RefEngine
from adlb_tpu_torch.balancer.engine import PlanEngine

TYPES = (1, 2, 3, 4)
WEIGHTS = {1: 3.0, 2: 0.25}


def _pin(eng):
    eng.PUMP_INTERVAL = 0.0
    eng.INFLOW_MIN_AGE = 0.0
    eng.INFLOW_TTL = 1e9
    eng.SUPPRESS_TTL = 1e9
    eng.PARK_RECENT = 1e9
    eng.LOOK_GROW_WINDOW = 1e9
    return eng


def _engines(host_ledger, J, threshold):
    kw = dict(types=TYPES, max_tasks=12, max_requesters=6,
              host_ledger=host_ledger, max_jobs=J,
              job_weights=WEIGHTS if J > 1 else None)
    if threshold is not None:
        kw["host_threshold_reqs"] = threshold
    return (_pin(RefEngine(backend="xla", **kw)),
            _pin(PlanEngine(device="cpu", **kw)))


def _task(rng, seq, J):
    seq[0] += 1
    tk = (seq[0], int(rng.choice(TYPES)), int(rng.integers(-9, 10)), 8)
    if J > 1 and rng.random() < 0.5:
        tk = tk + (int(rng.integers(1, J + 1)),)
    return tk


def _server(rng, s, seq, J, stamp, tag):
    tasks = sorted((_task(rng, seq, J) for _ in range(int(rng.integers(0, 10)))),
                   key=lambda t: -t[2])
    reqs = []
    for r in range(int(rng.integers(0, 5))):
        types = None if rng.random() < 0.2 else sorted(
            {int(rng.choice(TYPES)) for _ in range(int(rng.integers(1, 3)))})
        rq = ((s - 100) * 50 + r + tag, int(rng.integers(1, 1000)), types)
        if J > 1 and rng.random() < 0.5:
            rq = rq + (0, int(rng.integers(1, J + 1)))
        reqs.append(rq)
    return {"tasks": tasks, "reqs": reqs, "consumers": int(rng.integers(0, 3)),
            "stamp": stamp, "task_stamp": stamp}


def _step(rng, pair, seq, rnd, matches, J):
    """One world step, applied identically to both dicts."""
    t = time.monotonic()
    for snaps in pair:
        for holder, seqno, req_home, for_rank, rqseqno in matches:
            hs = snaps.get(holder)
            if hs is not None:
                hs["tasks"] = [x for x in hs["tasks"] if x[0] != seqno]
                hs["task_stamp"] = t
            rs = snaps.get(req_home)
            if rs is not None:
                rs["reqs"] = [r for r in rs["reqs"]
                              if not (r[0] == for_rank and r[1] == rqseqno)]
                rs["stamp"] = t
    ranks = sorted(pair[0])
    if not ranks:
        return
    if rng.random() < 0.7:  # in-place task delta
        tgt = int(rng.choice(ranks))
        unit = _task(rng, seq, J)
        for snaps in pair:
            snaps[tgt]["tasks"].append(unit)
            snaps[tgt]["delta_seq"] = snaps[tgt].get("delta_seq", 0) + 1
    if rng.random() < 0.4:  # dead-rank requester patch
        tgt = int(rng.choice(ranks))
        dead = int(rng.integers(0, 400))
        for snaps in pair:
            kept = [r for r in snaps[tgt]["reqs"] if r[0] != dead]
            if len(kept) != len(snaps[tgt]["reqs"]):
                snaps[tgt]["reqs"] = kept
                snaps[tgt]["req_seq"] = snaps[tgt].get("req_seq", 0) + 1
    if rng.random() < 0.15 and len(ranks) > 2:  # server death
        tgt = int(rng.choice(ranks))
        for snaps in pair:
            snaps.pop(tgt, None)
    for _ in range(int(rng.integers(1, 3))):  # restamps, rejoins included
        tgt = 100 + int(rng.integers(0, 8))
        fresh = _server(rng, tgt, seq, J, time.monotonic(), 20 + rnd)
        for snaps in pair:
            snaps[tgt] = copy.deepcopy(fresh)


@pytest.mark.parametrize("threshold", [0, None])
@pytest.mark.parametrize("host_ledger", ["array", "py"])
@pytest.mark.parametrize("J", [1, 3])
def test_rounds_identical(J, host_ledger, threshold):
    ref, port = _engines(host_ledger, J, threshold)
    for seed in range(2):
        rng = np.random.default_rng(100 * J + seed)
        seq = [0]
        now = time.monotonic()
        snaps_ref = {s: _server(rng, s, seq, J, now, 0)
                     for s in range(100, 108)}
        snaps_port = copy.deepcopy(snaps_ref)
        produced = 0
        for rnd in range(12):
            if rnd == 6 and J > 1:
                for e in (ref, port):  # live reweight mid-drive
                    e.set_job_weights({1: 0.5, 2: 2.0})
            got_ref = ref.round(snaps_ref, None)
            got_port = port.round(snaps_port, None)
            assert got_port == got_ref, (seed, rnd)
            produced += len(got_ref[0]) + len(got_ref[1])
            _step(rng, (snaps_ref, snaps_port), seq, rnd, got_ref[0], J)
        assert produced > 0
    assert port.solver.solve_count == ref.solver.solve_count
    assert port.solver.host_solve_count == ref.solver.host_solve_count
