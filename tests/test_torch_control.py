"""The port's control plane against the JAX package: the SLO engine
(``obs/slo.py``), the fleet controller (``control/``), periodic statistics
(``runtime/stats.py``), the ops endpoint (``obs/ops_server.py``) and tail
hedging's server path (``suspect_ranks`` from ``obs/slo.py``).

* **Parity** — the same objective and policy documents and the same
  sequence of fleet observations (made from a numpy seed) give the same
  alert transitions, published alert rows and controller decisions in
  both packages; the same server counters give the same ``STAT_APS``
  lines.
* **Worlds** — a planned port world with ``ops_port=0`` whose job weight
  a ``POST /jobs/<id>`` changes mid-run: the change reaches
  ``PlanEngine.set_job_weights`` and the solver's ``set_job_bias``, and
  ``/metrics``, ``/alerts`` (the SLO engine's alerts) and ``/control``
  answer; a periodic-stats world aggregates every server.
* **Hedging** — ``tests/test_hedge.py``'s handler-driven server tests
  (``:204``, ``:224``) against the port's ``Server``.
"""

import json
import os
import struct
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.control import controller as ref_controller
from adlb_tpu.obs import metrics as ref_metrics
from adlb_tpu.obs import slo as ref_slo
from adlb_tpu.runtime import stats as ref_stats
from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.balancer import engine as engine_mod
from adlb_tpu_torch.balancer import solve
from adlb_tpu_torch.control import controller
from adlb_tpu_torch.obs import metrics, slo
from adlb_tpu_torch.runtime import stats
from adlb_tpu_torch.runtime.messages import Tag, msg
from adlb_tpu_torch.runtime.server import Server
from adlb_tpu_torch.runtime.transport import InProcFabric
from adlb_tpu_torch.runtime.world import Config, WorldSpec
from adlb_tpu_torch.types import ADLB_FENCED, ADLB_SUCCESS

T = 1


# ----------------------------------------------------------------- parity


OBJECTIVES = [
    {"job": 0, "type": 1, "p99_ms": 5, "window_s": 10, "for_s": 1.0,
     "cooldown_s": 1.0},
    {"name": "errors", "job": 0, "type": 2, "error_frac": 0.05,
     "window_s": 8, "for_s": 0.5},
]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_engine_parity(seed):
    """Both engines see the same merged fleet registry every tick (latency
    and error phases from a numpy seed, an epoch bump and a stale rank
    midway) and must agree on every transition and published row."""
    rng = np.random.default_rng(seed)
    engines = [slo.SloEngine(0.5), ref_slo.SloEngine(0.5)]
    regs = [metrics.Registry(0), ref_metrics.Registry(0)]
    for eng in engines:
        for doc in OBJECTIVES:
            eng.add(dict(doc))
    now = 100.0
    for tick in range(60):
        slow = rng.random() < (0.8 if 15 <= tick < 35 else 0.05)
        lat = rng.uniform(0.02, 0.08, 20) if slow else \
            rng.uniform(0.0001, 0.002, 20)
        errs = int(rng.integers(0, 4)) if 25 <= tick < 45 else 0
        for reg in regs:
            h = reg.histogram("unit_total_s", job="0", type="1")
            for x in lat:
                h.observe(float(x))
            reg.histogram("unit_total_s", job="0", type="2").observe(0.001)
            reg.counter("unit_errors", job="0", type="2").inc(errs)
        if tick == 30:
            for eng in engines:
                eng.note_epoch(1, now)
        stale = [3] if 40 <= tick < 44 else []
        outs = [eng.evaluate(now, type(reg).merge([reg.snapshot()]), stale)
                for eng, reg in zip(engines, regs)]
        assert outs[0] == outs[1]
        now += 0.5
    assert engines[0].history == engines[1].history
    assert engines[0].history, "no transition at all"
    assert engines[0].alerts_pub == engines[1].alerts_pub
    tails = [{"slow_rank": 5}, {"id": 1}]
    deltas = {f"{slo.LEASE_EXPIRY_PREFIX}7}}": 2.0,
              f"{slo.LEASE_EXPIRY_PREFIX}8}}": 0.0}
    assert slo.suspect_ranks([2], tails, deltas) == \
        ref_slo.suspect_ranks([2], tails, deltas) == {2, 5, 7}


@pytest.mark.parametrize("seed", [0, 3])
def test_controller_parity(seed):
    """The same policy and the same fleet frames (pressure, backlog,
    firing alerts, tenants, epoch bumps from a numpy seed) give the same
    decisions, published state and action count in both packages."""
    rng = np.random.default_rng(seed)
    policy = {"cooldown_s": 4.0, "max_servers": 6, "min_servers": 2}
    ctls = [controller.Controller(dict(policy), eval_interval=1.0, now=0.0),
            ref_controller.Controller(dict(policy), eval_interval=1.0,
                                      now=0.0)]
    epoch = 0
    for i in range(80):
        now = 1.0 + i
        if rng.random() < 0.05:
            epoch += 1
        jobs = {j: {"depth": int(rng.integers(0, 12)),
                    "bytes": int(rng.integers(0, 1000)),
                    "quota_bytes": int(rng.choice([0, 0, 64])),
                    "state": "running"} for j in range(3)}
        frame = {"live_servers": int(rng.integers(2, 6)),
                 "pressure": {4: float(rng.random()),
                              5: float(rng.random())},
                 "firing": int(rng.integers(0, 2)), "jobs": jobs,
                 "backoffs": int(rng.integers(0, 3)),
                 "oldest_lease_s": float(rng.random() * 5), "epoch": epoch}
        outs = [c.evaluate(now, json.loads(json.dumps(frame)))
                for c in ctls]
        assert outs[0] == outs[1]
        if i == 40:
            for c in ctls:
                c.update_policy({"dry_run": True})
    assert list(ctls[0].history) == list(ctls[1].history)
    assert {d["outcome"] for d in ctls[0].history} >= {
        controller.ACT, controller.DRY_RUN}
    assert ctls[0].policy_doc() == ctls[1].policy_doc()
    assert controller.parse_policy({"cooldown_s": 2}) == \
        ref_controller.parse_policy({"cooldown_s": 2})


def _fake_server(rng, rank):
    units = [types.SimpleNamespace(work_type=int(rng.integers(1, 5)),
                                   target_rank=int(rng.integers(-1, 4)))
             for _ in range(int(rng.integers(0, 30)))]
    vals = {"puts": float(rng.integers(0, 500))}
    return types.SimpleNamespace(
        rank=rank, wq=types.SimpleNamespace(units=lambda: units,
                                            count=len(units)),
        rq=[None] * int(rng.integers(0, 6)),
        metrics=types.SimpleNamespace(value=vals.get),
        resolved_reserves=int(rng.integers(0, 400)),
        mem=types.SimpleNamespace(curr=int(rng.integers(0, 1 << 20))))


@pytest.mark.parametrize("seed", [0, 1])
def test_periodic_stats_lines_equal(seed):
    """The same counters on 40 servers give byte-equal STAT_APS lines (a
    multi-chunk record) and the same decoded rows in both packages."""
    rng = np.random.default_rng(seed)
    servers = [_fake_server(rng, 40 + r) for r in range(40)]
    lines = {}
    for mod in (stats, ref_stats):
        out = lines[mod] = []
        mod.set_sink(out.append)
        try:
            token = {"seq": 3, "t0": 10.0, "entries": {
                s.rank: mod.contribution(s) for s in servers}}
            mod.emit_stat_aps(mod.aggregate(token, 10.25))
        finally:
            mod.set_sink(None)
    assert lines[stats] == lines[ref_stats] and len(lines[stats]) > 1
    assert stats.summarize(stats.parse_stat_lines(lines[ref_stats])) == \
        ref_stats.summarize(ref_stats.parse_stat_lines(lines[stats]))


# ----------------------------------------------------------------- worlds


def test_periodic_stats_world_aggregates_all_servers():
    lines = []
    stats.set_sink(lines.append)

    def app(ctx):
        if ctx.rank == 0:
            for i in range(40):
                ctx.put(b"x" * 64, work_type=1, work_prio=i)
        done = 0
        while True:
            rc, r = ctx.reserve([1])
            if rc < 0:
                break
            ctx.get_reserved(r.handle)
            done += 1
            time.sleep(0.002)
            if ctx.rank == 0 and done == 10:
                time.sleep(0.15)  # at least two stat periods
        if ctx.rank == 0:
            ctx.set_problem_done()
        return done

    try:
        run_world(num_app_ranks=3, nservers=3, types=[1], app_fn=app,
                  cfg=Config(balancer="tpu", device="cpu",
                             solver_host_threshold=0,
                             periodic_log_interval=0.03,
                             exhaust_check_interval=0.5), timeout=60.0)
    finally:
        stats.set_sink(None)
    records = stats.parse_stat_lines(lines)
    assert records and all(r["nservers"] == 3 for r in records)
    puts = [r["total"]["puts"] for r in records]
    assert puts == sorted(puts) and puts[-1] == 40


def test_ops_post_job_weight_reaches_the_engine(tmp_path, monkeypatch):
    """Two weighted jobs planned on the device path; mid-run rank 0 POSTs
    job 1's weight to the ops endpoint. The engine's next round applies
    it (set_job_weights), the solver's job bias changes (set_job_bias),
    both jobs complete, and /metrics, /alerts and /control answer."""
    applied, biased = [], []
    sjw = engine_mod.PlanEngine.set_job_weights
    sjb = solve.AssignmentSolver.set_job_bias

    def set_job_weights(self, w):
        changed = sjw(self, w)
        applied.append((dict(w or {}), changed))
        return changed

    def set_job_bias(self, w):
        changed = sjb(self, w)
        biased.append((dict(w or {}), changed, list(self.job_bias)))
        return changed

    monkeypatch.setattr(engine_mod.PlanEngine, "set_job_weights",
                        set_job_weights)
    monkeypatch.setattr(solve.AssignmentSolver, "set_job_bias",
                        set_job_bias)
    answers = {}
    ready = threading.Event()

    def app(ctx):
        if ctx.rank == 0:
            assert ctx.submit_job("a") == (ADLB_SUCCESS, 1)
            assert ctx.submit_job("b") == (ADLB_SUCCESS, 2)
            ready.set()
            deadline = time.monotonic() + 20
            path = tmp_path / "ops_endpoint.json"
            while not path.exists() and time.monotonic() < deadline:
                time.sleep(0.01)
            base = f"http://127.0.0.1:{json.loads(path.read_text())['port']}"
            req = urllib.request.Request(
                f"{base}/jobs/1", data=json.dumps({"weight": 3.0}).encode(),
                method="POST")
            answers["post"] = json.load(urllib.request.urlopen(req,
                                                               timeout=10))
            for jid in (1, 2):
                ctx.attach(jid)
                for i in range(20):
                    assert ctx.put(struct.pack("<q", 100 * jid + i), T,
                                   work_prio=i) == ADLB_SUCCESS
            for route in ("metrics", "alerts", "control"):
                with urllib.request.urlopen(f"{base}/{route}",
                                            timeout=10) as r:
                    answers[route] = (r.status, r.read())
            ctx.drain_job(1)
            ctx.drain_job(2)
            return None
        ready.wait(20)
        jid = 1 + ctx.rank % 2
        ctx.attach(jid)
        got = []
        while True:
            rc, w = ctx.get_work([T])
            if rc != ADLB_SUCCESS:
                return (jid, got)
            got.append(struct.unpack("<q", w.payload)[0])

    res = run_world(
        5, 2, [T], app,
        cfg=Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                   put_routing="home", balancer_max_jobs=3,
                   job_weights={2: 4.0}, ops_port=0,
                   ops_announce_dir=str(tmp_path), obs_sync_interval=0.1,
                   slo=[{"name": "o1", "p99_ms": 1e6, "window_s": 60}],
                   control=True, control_dry_run=True,
                   exhaust_check_interval=0.2),
        timeout=90.0)
    got = {jid: sorted(x for r, v in res.app_results.items() if v
                       and v[0] == jid for x in v[1]) for jid in (1, 2)}
    assert got == {j: [100 * j + i for i in range(20)] for j in (1, 2)}
    assert answers["post"]["weight"] == 3.0
    assert ({1: 3.0, 2: 4.0}, True) in applied
    assert any(w == {1: 3.0, 2: 4.0} and changed for w, changed, _ in biased)
    assert all(answers[r][0] == 200 for r in ("metrics", "alerts",
                                              "control"))
    assert b"adlb_" in answers["metrics"][1]
    assert [o["name"] for o in json.loads(answers["alerts"][1])[
        "objectives"]] == ["o1"]
    assert json.loads(answers["control"][1])["enabled"]


# ---------------------------------------------------------------- hedging


def _srv(**cfg_kw):
    cfg_kw.setdefault("on_worker_failure", "reclaim")
    cfg_kw.setdefault("lease_timeout_s", 0.5)
    cfg_kw.setdefault("hedge_budget_frac", 0.5)
    cfg_kw.setdefault("hedge_min_age_ms", 50.0)
    world = WorldSpec(nranks=4, nservers=2, types=(T,))
    fabric = InProcFabric(4)
    return Server(world, Config(device="cpu", **cfg_kw),
                  fabric.endpoint(2)), fabric


def _drain(fabric, rank):
    out = []
    while (m := fabric.endpoints[rank].recv(timeout=0.0)) is not None:
        out.append(m)
    return out


def _hedge_setup(srv, fabric, thr=0.2, age=1.0):
    """put, rank 0 pins, rank 1 parks, the scan launches the sibling."""
    srv._handle(msg(Tag.FA_PUT, 0, payload=b"unit", work_type=T, prio=0,
                    target_rank=-1, answer_rank=-1, common_len=0,
                    common_server=-1, common_seqno=-1))
    [u] = list(srv.wq.units())
    for rank in (0, 1):
        srv._handle(msg(Tag.FA_RESERVE, rank, req_types=[T], hang=True,
                        rqseqno=1))
        got = [m for m in _drain(fabric, rank)
               if m.tag is Tag.TA_RESERVE_RESP]
        assert bool(got) == (rank == 0), "rank 1 did not park"
    srv.journeys.tail_thr[(0, T)] = thr
    srv._scan_hedges(time.monotonic() + age)
    resp = [m for m in _drain(fabric, 1)
            if m.tag is Tag.TA_RESERVE_RESP][-1]
    assert resp.rc == ADLB_SUCCESS
    return u.seqno, resp.handle[0]


def _fetch(srv, fabric, rank, seqno):
    srv._handle(msg(Tag.FA_GET_RESERVED, rank, seqno=seqno))
    return [m for m in _drain(fabric, rank)
            if m.tag is Tag.TA_GET_RESERVED_RESP][-1]


def test_hedge_launches_pinned_sibling_at_parked_rank():
    srv, fabric = _srv()
    origin, sib = _hedge_setup(srv, fabric)
    assert sib != origin
    assert srv.metrics.value("hedges_launched") == 1
    assert srv.wq.count == 2 and len(srv.leases) == 2
    o, s = srv.wq.get(origin), srv.wq.get(sib)
    assert o.pinned and o.pin_rank == 0 and s.pinned and s.pin_rank == 1
    assert srv.hedges.is_member(origin) and srv.hedges.is_member(sib)
    assert any(t.startswith("hedge_launched") and "why=thr" in t
               for _, t in srv.flight.entries())
    assert srv.hedges.tokens(0) == 0.0


@pytest.mark.parametrize("winner", ["sibling", "origin"])
def test_first_terminal_wins_loser_fenced(winner):
    srv, fabric = _srv()
    origin, sib = _hedge_setup(srv, fabric)
    first = (1, sib) if winner == "sibling" else (0, origin)
    second = (0, origin) if winner == "sibling" else (1, sib)
    resp = _fetch(srv, fabric, *first)
    assert resp.rc == ADLB_SUCCESS and resp.payload == b"unit"
    assert srv.wq.count == 0 and len(srv.leases) == 0
    assert (second[1], second[0]) in srv._fences
    assert _fetch(srv, fabric, *second).rc == ADLB_FENCED
    assert srv.metrics.value("hedges_fenced") == 1
    assert srv.metrics.value("hedges_won") == (winner == "sibling")
    assert srv.wq.num_unpinned() == 0


def test_no_silent_import_gate_is_left():
    """Every module the server reaches for these features is part of the
    port (the old deferred-import gate is gone)."""
    root = os.path.join(os.path.dirname(__file__), "..", "adlb_tpu_torch")
    assert not os.path.exists(os.path.join(root, "unported.py"))
    import adlb_tpu_torch.control
    import adlb_tpu_torch.obs.ops_server
    import adlb_tpu_torch.runtime.checkpoint
    import adlb_tpu_torch.runtime.spill  # noqa: F401
    assert adlb_tpu_torch.control.Controller is controller.Controller
