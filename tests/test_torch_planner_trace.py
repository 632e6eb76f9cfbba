"""The sharded planner's phases as spans on the runtime's tracer: the spans
of one round on both ingest paths (snapshot tuples and the array ledger's
view), their nesting and counts, plans unchanged with the tracer attached,
the tracer's clock, and the engine handing its tracer to the solver. CPU
only, at small sizes."""

import copy
import time

import numpy as np
import pytest

from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver
from adlb_tpu_torch.balancer.engine import PlanEngine
from adlb_tpu_torch.runtime.trace import Tracer, clock

TYPES = (1, 2, 3, 4)
K, R = 6, 4

INGEST = {"planner:ingest.diff", "planner:ingest.pack",
          "planner:ingest.upload", "planner:ingest.reqwin"}
DEVICE_PLAN = {"planner:plan.enqueue", "planner:plan.readback",
               "planner:plan.extract"}
TABLE = {"planner:ingest", "planner:plan"} | INGEST | DEVICE_PLAN


def _solver(tracer=None, auction="device", servers=8):
    return DistributedAssignmentSolver(
        TYPES, K, R, nshards=2, servers_per_shard=-(-servers // 2),
        rounds=8, cand_width=4, auction=auction, device="cpu",
        tracer=tracer)


def _snaps(stamp=1.0):
    """Eight servers (ranks 10-17): the even ones hold tasks of every type,
    the odd ones park a requester of each type."""
    out = {}
    seq = 0
    for s in range(10, 18):
        tasks, reqs = [], []
        if s % 2 == 0:
            for i, t in enumerate(TYPES):
                seq += 1
                tasks.append((seq, t, 10 - i, 8))
        else:
            reqs = [(100 * s + i, i + 1, [t]) for i, t in enumerate(TYPES)]
        out[s] = {"tasks": tasks, "reqs": reqs, "stamp": stamp,
                  "task_stamp": stamp}
    return out


def _by_name(events):
    out = {}
    for e in events:
        assert e["ph"] == "X"
        assert e["name"] not in out, f"{e['name']} twice in one round"
        out[e["name"]] = e
    return out


def _check_round(events, names):
    """Exactly ``names``; each child inside its parent and the children's
    durations within the parent's; one ``round`` for every span."""
    spans = _by_name(events)
    assert set(spans) == names
    assert len({e["args"]["round"] for e in events}) == 1
    for top in ("planner:ingest", "planner:plan"):
        p = spans[top]
        assert p["args"]["parent"] is None
        kids = [e for e in events if e["args"]["parent"] == top]
        assert kids and all(e["name"].startswith(top + ".") for e in kids)
        for e in kids:
            assert e["ts"] >= p["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
        assert sum(e["dur"] for e in kids) <= p["dur"] + 1e-3
    return spans


def test_tuple_path_round_emits_the_table():
    tr = Tracer(0, pid=1)
    sol = _solver()
    snaps = _snaps()
    sol.ingest(snaps)
    sol.plan()
    sol.tracer = tr
    # a hand-built delta: two holders' tasks change, one requester list
    # changes, one server vanishes (its parked requesters leave with it)
    snaps = copy.deepcopy(snaps)
    for s, st in ((10, 2.0), (12, 2.0)):
        snaps[s]["tasks"] = [(900 + s, 2, 50, 8)]
        snaps[s]["task_stamp"] = st
    snaps[11]["reqs"] = [(1111, 9, [2]), (1112, 10, None)]
    snaps[11]["stamp"] = 2.0
    del snaps[17]
    n = sol.ingest(snaps)
    pairs = sol.plan()
    spans = _check_round(tr.events, TABLE)
    assert spans["planner:ingest"]["args"]["path"] == "tuple"
    assert spans["planner:ingest"]["args"]["walked"] == len(snaps) == 7
    diff = spans["planner:ingest.diff"]["args"]
    # the first plan's servers are compared again whatever their stamps
    # say; only the edited ones differ
    assert diff["walked"] == 7 and diff["vanished"] == 1
    assert diff["task_changed"] == 2 and diff["req_changed"] == 1
    assert diff["servers_changed"] == 3
    pack = spans["planner:ingest.pack"]["args"]
    assert pack["task_rows"] == n == 2
    assert pack["req_servers"] == 1 and pack["req_rows"] == 2
    up = spans["planner:ingest.upload"]["args"]
    assert up["rows"] == n and up["pieces"] == 1
    assert up["bytes"] == n * 4 * (2 * K + 2)
    assert spans["planner:ingest.reqwin"]["args"]["bytes"] > 0
    assert spans["planner:plan"]["args"]["pairs"] == len(pairs) > 0
    assert spans["planner:plan.extract"]["args"]["pairs"] == len(pairs)
    # the plain versions run on the CPU: no kernel launches
    assert spans["planner:plan.enqueue"]["args"]["launches"] == 0
    T, C = sol.T, sol.C
    assert spans["planner:plan.readback"]["args"]["bytes"] == 4 * T * (C + 1)
    # the spans are the timers' own intervals
    assert spans["planner:ingest"]["dur"] == pytest.approx(
        1e3 * sol.last_ingest_ms)
    assert spans["planner:plan.extract"]["dur"] == pytest.approx(
        1e3 * sol.last_extract_ms)
    assert (spans["planner:plan.enqueue"]["dur"]
            + spans["planner:plan.readback"]["dur"]
            <= 1e3 * sol.last_solve_ms + 1e-3)


def _ledger_view(snaps):
    """The array ledger of an engine without a tracer, synced to
    ``snaps``: the view the engine hands its solver."""
    eng = PlanEngine(TYPES, K, R, use_mesh=True, nshards=2, nservers=8,
                     device="cpu")
    led = eng._ledger
    now = time.monotonic()
    led.sync(snaps, now)
    led.filter_reqs(snaps, {}, now)
    return led.view()


def test_view_path_round_emits_the_table():
    tr = Tracer(0, pid=1)
    sol = _solver(tracer=tr)
    view = _ledger_view(_snaps())
    n = sol._ingest_view(view)
    pairs = sol.plan()
    spans = _check_round(tr.events, TABLE)
    assert spans["planner:ingest"]["args"]["path"] == "view"
    assert spans["planner:ingest"]["args"]["walked"] == len(view.servers) == 8
    diff = spans["planner:ingest.diff"]["args"]
    assert diff["walked"] == 8
    assert diff["task_changed"] == diff["req_changed"] == 8
    assert diff["servers_changed"] == 8
    pack = spans["planner:ingest.pack"]["args"]
    assert pack["task_rows"] == n == 8
    assert pack["req_servers"] == 8 and pack["req_rows"] == 4 * len(TYPES)
    assert spans["planner:ingest.upload"]["args"]["rows"] == n
    assert spans["planner:plan"]["args"]["pairs"] == len(pairs) > 0


def test_host_tier_plans_under_one_child():
    tr = Tracer(0, pid=1)
    sol = _solver(tracer=tr, auction="host")
    sol.ingest(_snaps())
    sol.plan()
    names = (TABLE - DEVICE_PLAN) | {"planner:plan.host",
                                     "planner:plan.extract"}
    spans = _check_round(tr.events, names)
    assert spans["planner:ingest.reqwin"]["args"]["bytes"] == 0
    assert spans["planner:plan.host"]["args"]["swept"] is True


def test_tracer_attached_between_rounds_labels_each_round():
    sol = _solver()
    assert sol.tracer is None
    sol.ingest(_snaps())
    sol.plan()
    tr = Tracer(0, pid=1)
    sol.tracer = tr
    for st in (2.0, 3.0):
        snaps = _snaps(st)
        sol.ingest(snaps)
        sol.plan()
    rounds = sorted({e["args"]["round"] for e in tr.events})
    assert rounds == [1, 2]
    for r in rounds:
        _check_round([e for e in tr.events if e["args"]["round"] == r],
                     {e["name"] for e in tr.events
                      if e["args"]["round"] == r})


class _Churn:
    """Bursts into a few servers a round, the plan consumed, matched
    requesters re-parked with a fresh type, and now and then a server
    leaving and coming back: stamps ride the snapshots as the engine's."""

    def __init__(self, seed, nservers=12):
        self.rng = np.random.default_rng(seed)
        self.clock = 1.0
        self.seq = 0
        self.rq = 0
        self.snaps = {}
        self.away = {}
        for s in range(20, 20 + nservers):
            self.snaps[s] = {
                "tasks": [], "reqs": [self._req(s) for _ in range(R)],
                "stamp": self._tick(), "task_stamp": self.clock}

    def _tick(self):
        self.clock += 1.0
        return self.clock

    def _req(self, s):
        self.rq += 1
        t = int(self.rng.choice(TYPES))
        return (1000 * s + self.rq % 997, self.rq, [t])

    def round(self):
        ranks = sorted(self.snaps)
        for s in self.rng.choice(ranks, 3, replace=False).tolist():
            snap = self.snaps[s]
            burst = []
            for _ in range(4):
                self.seq += 1
                burst.append((self.seq, int(self.rng.choice(TYPES)),
                              int(self.rng.integers(-9, 10)), 8))
            snap["tasks"] = sorted(snap["tasks"] + burst,
                                   key=lambda t: -t[2])[:K]
            snap["task_stamp"] = self._tick()
        if self.away:
            s, snap = self.away.popitem()
            self.snaps[s] = snap
            snap["stamp"] = snap["task_stamp"] = self._tick()
        elif self.rng.random() < 0.3:
            s = int(self.rng.choice(ranks))
            self.away[s] = self.snaps.pop(s)
        return self.snaps

    def consume(self, pairs):
        for holder, seqno, req_home, for_rank, rqseqno in pairs:
            h = self.snaps.get(holder)
            if h is not None:
                h["tasks"] = [t for t in h["tasks"] if t[0] != seqno]
                h["task_stamp"] = self._tick()
            q = self.snaps.get(req_home)
            if q is not None:
                q["reqs"] = [r for r in q["reqs"]
                             if (r[0], r[1]) != (for_rank, rqseqno)] + [
                    self._req(req_home)]
                q["stamp"] = self._tick()


@pytest.mark.parametrize("seed", [2**31 + 11, 7])
def test_plans_bit_identical_with_tracer_on_and_off(seed):
    tr = Tracer(0, pid=1)
    on, off = _solver(tracer=tr, servers=12), _solver(servers=12)
    gen_on, gen_off = _Churn(seed), _Churn(seed)
    planned = 0
    for _ in range(30):
        n_on = on.ingest(gen_on.round())
        n_off = off.ingest(gen_off.round())
        assert n_on == n_off
        p_on, p_off = on.plan(), off.plan()
        assert p_on == p_off
        if off.last_assigned is not None:
            assert np.array_equal(on.last_assigned, off.last_assigned)
        for a in ("_tp", "_tt", "_req_valid", "_req_mask"):
            assert np.array_equal(getattr(on, a), getattr(off, a)), a
        assert on._servers == off._servers
        gen_on.consume(p_on)
        gen_off.consume(p_off)
        planned += len(p_on)
    assert planned > 0
    assert {e["args"]["round"] for e in tr.events
            if e["name"] == "planner:plan"} == set(range(30))


def test_tracer_clock_is_perf_counter():
    tr = Tracer(3, pid=1)
    with tr.span("x"):
        t_mid = time.perf_counter() * 1e6
    ev = tr.events[-1]
    assert abs(ev["ts"] - t_mid) < 1e3
    assert abs(clock() - time.perf_counter()) < 1e-3
    t0 = clock()
    t1 = t0 + 0.25
    tr.complete("y", t0, t1, round=4, parent=None)
    ev = tr.events[-1]
    assert ev["ph"] == "X" and ev["tid"] == 3 and ev["pid"] == 1
    assert ev["ts"] * 1e-6 == pytest.approx(t0, abs=1e-9)
    assert (ev["ts"] + ev["dur"]) * 1e-6 == pytest.approx(t1, abs=1e-9)
    assert ev["args"] == {"round": 4, "parent": None}


def test_plan_engine_hands_its_tracer_to_the_sharded_solver():
    tr = Tracer(0, pid=1)
    eng = PlanEngine(TYPES, K, R, use_mesh=True, nshards=2, nservers=8,
                     device="cpu", tracer=tr)
    assert isinstance(eng.solver, DistributedAssignmentSolver)
    assert eng.solver.tracer is tr
    matches, _ = eng.round(_snaps(time.monotonic()), None)
    assert matches
    names = {e["name"] for e in tr.events}
    assert {"planner:ingest", "planner:plan"} <= names
    assert INGEST - {"planner:ingest.reqwin"} <= names
    ingest = [e for e in tr.events if e["name"] == "planner:ingest"]
    assert ingest[0]["args"]["path"] == "view"


def test_deferred_records_count_against_max_events():
    tr = Tracer(0, pid=1, max_events=4)
    tr.instant("a")
    for i in range(5):
        tr.complete(f"s{i}", 1.0, 2.0, round=i)
    assert tr.dropped == 2
    names = [e["name"] for e in tr.events]
    assert names == ["a", "s0", "s1", "s2"]
    # rendered records leave the store: the next read adds nothing
    assert len(tr.events) == 4
    tr.instant("b")
    assert tr.dropped == 3
