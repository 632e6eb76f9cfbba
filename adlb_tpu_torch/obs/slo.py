"""SLO engine: burn-rate alerting + live incident capture .

The "decide" layer of the sense → decide → act loop. The obs plane gives the
master a merged fleet registry, tail-promoted journeys, and a continuous
profiler; the membership plane gives it actuators. This module evaluates that merged
view against **declarative per-job objectives** (``Config(slo=...)`` or
``POST /slo``) every obs tick, on the master, and turns violations into
a durable alert lifecycle a controller (``control/``) can subscribe to
instead of polling raw gauges.

**Objectives** are plain dicts, e.g.::

    {"job": 0, "type": 3, "p99_ms": 50, "error_frac": 0.001,
     "window_s": 300}

``p99_ms`` bounds the windowed p99 of ``unit_total_s`` for that
(job, type); ``error_frac`` bounds the windowed fraction of closes that
ended anomalously (``unit_errors`` / closes). At least one term is
required; ``window_s`` is the SLOW window.

**Multi-window burn rates** (the standard SRE/Prometheus recording-rules
shape): every evaluation appends the merged registry to a bounded
:class:`~adlb_tpu_torch.obs.metrics.SnapshotRing`, so both a FAST window
(default ``window_s / 12``, floored at two evaluation ticks) and the
slow window are two-snapshot subtractions. The fast window catches a
fresh burn within seconds; the slow window refuses to confirm a blip
(one slow unit among a window's thousands moves neither its p99 nor its
error fraction). Fast-only burn = PENDING (about to page); slow-only
burn = a "warn"-severity PENDING (a slow simmer); **both burning,
sustained past ``for_s``, fires** — the no-flapping-on-blips property is
structural, not a tuned threshold.

**Staleness-aware**: the merged registry already carries a stale rank's
last gossiped snapshot (the master never zeroes a rank it stopped
hearing from), so a wedged server's contribution degrades to
"last known value" rather than silently vanishing; every alert row
evaluated while any live member is stale (the ``/healthz`` rule:
age > 3 × ``obs_sync_interval``) is flagged ``degraded`` with the rank
list, so a consumer can tell "fleet is healthy" from "fleet looks
healthy because half of it went quiet".

**Churn hysteresis**: membership epoch bumps (attach/detach/
scale) open a grace hold during which alert STATE is frozen — burn
numbers keep updating, but a scale-out's transient cannot flap
PENDING→FIRING→RESOLVED. A cooldown (``cooldown_s`` clear-time before
RESOLVED) bounds flapping on the way down the same way ``for_s`` does on
the way up.

**Alert lifecycle**: OK → PENDING → FIRING → RESOLVED (→ PENDING again
on relapse). Each transition is returned to the caller (the master's
reactor), which records a flight event, updates the ``alerts_firing``
gauge, republishes the compact rows the SS_OBS_SYNC replies carry
fleet-wide, and — on a page-severity FIRING — snapshots a **live
incident bundle**: the violating (job, type)'s tail journeys with the
slow-stage/profiler-window annotations, the responsible ranks'
dominant stacks over the firing window, the merged metrics delta over
the burn window, suspect ranks (stale members, slow-stage ranks,
lease-expiry owners), and the epoch-stamped fleet topology — written
atomically into ``flight_dir`` and served at ``GET /incidents``.

Threading: ``evaluate`` runs on the master's reactor thread only; the
ops HTTP thread reads ``alerts_pub`` / ``wire`` / ``history``, which are
republished by swap (never mutated in place), the same discipline as the
fleet snapshot ledgers.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from adlb_tpu_torch.obs.metrics import SnapshotRing, quantile_of

# alert states (the lifecycle is append-only vocabulary: consumers
# switch on these strings, so renaming would break mixed-version fleets)
OK = "OK"
PENDING = "PENDING"
FIRING = "FIRING"
RESOLVED = "RESOLVED"

MAX_OBJECTIVES = 64
# ring depth bounds: at least a minute of context, at most ~2k merged
# snapshots (each is a few KiB on a busy fleet)
_RING_MIN = 64
_RING_MAX = 2048


def parse_objective(doc: dict, eval_interval: float = 1.0) -> dict:
    """Validate + normalize one objective dict (Config(slo=...) entries
    and POST /slo bodies go through the same gate). Raises ValueError
    with an operator-readable message — the ops route answers 400."""
    if not isinstance(doc, dict):
        raise ValueError(f"objective must be a dict, got {type(doc).__name__}")
    job = int(doc.get("job", 0))
    typ = int(doc.get("type", -1))
    p99_ms = doc.get("p99_ms")
    error_frac = doc.get("error_frac")
    if p99_ms is None and error_frac is None:
        raise ValueError("objective needs p99_ms and/or error_frac")
    if p99_ms is not None and float(p99_ms) <= 0:
        raise ValueError("p99_ms must be > 0")
    if error_frac is not None and not (0.0 < float(error_frac) <= 1.0):
        raise ValueError("error_frac must be in (0, 1]")
    window_s = float(doc.get("window_s", 0) or 0)
    if window_s <= 0:
        raise ValueError("window_s must be > 0")
    tick = max(eval_interval, 1e-3)
    # fast window: 1/12 of the slow one (the classic 5m/1h pairing's
    # ratio), floored at two evaluation ticks so a single tick's noise
    # cannot page on its own
    fast_s = float(doc.get("fast_s", 0) or 0) or max(window_s / 12.0,
                                                     2.0 * tick)
    fast_s = min(fast_s, window_s)
    severity = str(doc.get("severity", "page"))
    if severity not in ("page", "warn"):
        raise ValueError(f"unknown severity {severity!r}")
    kind = "p99" if p99_ms is not None else "err"
    if p99_ms is not None and error_frac is not None:
        kind = "p99+err"
    name = str(doc.get("name") or f"job{job}-type{typ}-{kind}")
    return {
        "name": name,
        "job": job,
        "type": typ,
        "p99_ms": float(p99_ms) if p99_ms is not None else None,
        "error_frac": float(error_frac) if error_frac is not None else None,
        "window_s": window_s,
        "fast_s": round(fast_s, 6),
        # sustain before firing / clear-time before resolving: both
        # floored at two ticks — one tick of hysteresis each way is the
        # minimum that makes a single noisy evaluation flap-proof
        "for_s": float(doc.get("for_s", 0) or 0) or 2.0 * tick,
        "cooldown_s": float(doc.get("cooldown_s", 0) or 0) or max(
            fast_s, 2.0 * tick),
        "severity": severity,
        "min_count": int(doc.get("min_count", 1) or 1),
    }


def _cell_key(name: str, job: int, typ: int) -> str:
    # merged-snapshot keys carry sorted labels: job before type
    return f"{name}{{job={job},type={typ}}}"


class SloEngine:
    """Master-side objective evaluator. One instance per master server;
    created at init when ``Config(slo=...)`` is set, or lazily by the
    first ``POST /slo``."""

    def __init__(self, eval_interval: float = 1.0,
                 now: Optional[float] = None) -> None:
        self.eval_interval = max(eval_interval, 1e-3)
        self.started_at = time.monotonic() if now is None else now
        self.objectives: list[dict] = []
        self.ring = SnapshotRing(_RING_MIN)
        self._alerts: dict[str, dict] = {}  # name -> live state (reactor)
        # published views (swapped whole; the ops HTTP thread and the
        # gossip reply path read these)
        self.alerts_pub: list[dict] = []
        self.wire: list = []
        self.history: deque = deque(maxlen=256)
        self.firing = 0
        # churn grace: epoch bumps freeze state transitions until this
        self._epoch: Optional[int] = None
        self._hold_until = 0.0

    # -- objectives ----------------------------------------------------------

    def add(self, doc: dict) -> dict:
        if len(self.objectives) >= MAX_OBJECTIVES:
            raise ValueError(f"at most {MAX_OBJECTIVES} objectives")
        o = parse_objective(doc, self.eval_interval)
        if any(x["name"] == o["name"] for x in self.objectives):
            raise ValueError(f"duplicate objective {o['name']!r}")
        self.objectives.append(o)
        # the ring must reach back one slow window (+ slack for the
        # baseline search landing between ticks)
        need = int(o["window_s"] / self.eval_interval) + 8
        self.ring.grow(max(_RING_MIN, min(need, _RING_MAX)))
        return o

    # -- churn hysteresis ----------------------------------------------------

    def note_epoch(self, epoch: int, now: float) -> None:
        """Membership change: freeze state transitions for a grace
        period so attach/detach/scale transients cannot flap alerts.
        Burn numbers keep updating — only the lifecycle holds."""
        if self._epoch is not None and epoch != self._epoch:
            self._hold_until = now + max(4.0 * self.eval_interval, 2.0)
        self._epoch = epoch

    # -- evaluation ----------------------------------------------------------

    def _burn(self, o: dict, window_s: float, now: float) -> tuple:
        """(burn, violating, detail) for one objective over one window.
        Burn is the worst term's ratio to its bound (>= 1.0 violates);
        p99 needs ``min_count`` in-window closes to arm (a cold window
        proves nothing)."""
        job, typ = o["job"], o["type"]
        burn = 0.0
        detail: dict = {}
        hd = self.ring.hist_delta(
            _cell_key("unit_total_s", job, typ), window_s, now)
        closes = 0
        if hd is not None:
            bounds, counts, n, span = hd
            closes = n
            detail["closes"] = n
            detail["span_s"] = round(span, 3)
            if o["p99_ms"] is not None and n >= o["min_count"]:
                p99_s = quantile_of(bounds, counts, n, 0.99)
                detail["p99_ms"] = round(p99_s * 1e3, 3)
                burn = max(burn, p99_s * 1e3 / o["p99_ms"])
        if o["error_frac"] is not None:
            errs, _span = self.ring.counter_delta(
                _cell_key("unit_errors", job, typ), window_s, now)
            if errs:
                # errored closes observe unit_total_s too, so closes is
                # the honest denominator; errors with zero recorded
                # closes (clock skew between the two folds) saturate
                frac = errs / closes if closes else 1.0
                detail["errors"] = int(errs)
                detail["error_frac"] = round(frac, 6)
                burn = max(burn, frac / o["error_frac"])
        return burn, burn >= 1.0, detail

    def evaluate(self, now: float, merged: dict,
                 stale_ranks: Optional[list] = None) -> list[dict]:
        """One evaluation tick: append ``merged`` to the ring, advance
        every objective's alert state machine, republish the HTTP/wire
        views, and return the transitions that happened this tick."""
        self.ring.append(now, merged)
        stale = sorted(stale_ranks or [])
        held = now < self._hold_until
        transitions: list[dict] = []
        firing = 0
        pub: list[dict] = []
        wire: list = []
        for o in self.objectives:
            st = self._alerts.get(o["name"])
            if st is None:
                st = self._alerts[o["name"]] = {
                    "state": OK, "since": now, "fired_at": None,
                    "clear_since": None, "fire_count": 0,
                }
            burn_f, viol_f, det_f = self._burn(o, o["fast_s"], now)
            burn_s, viol_s, det_s = self._burn(o, o["window_s"], now)
            prev = st["state"]
            nxt = prev
            if prev in (OK, RESOLVED):
                if viol_f or viol_s:
                    nxt = PENDING
            elif prev == PENDING:
                if not (viol_f or viol_s):
                    if not held:
                        nxt = OK
                elif viol_f and viol_s and not held and \
                        now - st["since"] >= o["for_s"]:
                    nxt = FIRING
            elif prev == FIRING:
                if viol_f or viol_s:
                    st["clear_since"] = None
                else:
                    if st["clear_since"] is None:
                        st["clear_since"] = now
                    if not held and \
                            now - st["clear_since"] >= o["cooldown_s"]:
                        nxt = RESOLVED
            if nxt != prev:
                st["state"] = nxt
                st["since"] = now
                if nxt == FIRING:
                    st["fired_at"] = now
                    st["fire_count"] += 1
                if nxt != FIRING:
                    st["clear_since"] = None
                tr = {
                    "name": o["name"], "from": prev, "to": nxt,
                    "at": now, "severity": o["severity"],
                    "job": o["job"], "type": o["type"],
                    "burn_fast": round(burn_f, 3),
                    "burn_slow": round(burn_s, 3),
                    "degraded": bool(stale),
                }
                transitions.append(tr)
                self.history.append(tr)
            if st["state"] == FIRING:
                firing += 1
            # row severity: both windows burning carries the
            # objective's severity (page by default); a single-window
            # burn is a warn — "fast pages, slow warns, both fire"
            row_sev = o["severity"] if (viol_f and viol_s) else (
                "warn" if (viol_f or viol_s) else o["severity"])
            pub.append({
                "name": o["name"], "state": st["state"],
                "severity": row_sev,
                "job": o["job"], "type": o["type"],
                "since": round(st["since"], 3),
                "fired_at": round(st["fired_at"], 3)
                if st["fired_at"] is not None else None,
                "fire_count": st["fire_count"],
                "burn_fast": round(burn_f, 3),
                "burn_slow": round(burn_s, 3),
                "fast": det_f, "slow": det_s,
                "window_s": o["window_s"], "fast_s": o["fast_s"],
                "degraded": bool(stale),
                "stale_ranks": stale,
                "held": held,
            })
            wire.append([o["name"], st["state"], row_sev,
                         round(burn_f, 3), round(burn_s, 3)])
        # publish-by-swap for the HTTP thread / gossip replies
        self.alerts_pub = pub
        self.wire = wire
        self.firing = firing
        return transitions


# ---------------------------------------------------------------- suspects

# the owner-labelled lease-expiry counter's snapshot key prefix (see
# Server._expire_lease): the window-delta of these cells names the
# stalled worker directly
LEASE_EXPIRY_PREFIX = "leases_expired_by{owner="


def suspect_ranks(stale_ranks, tails, counter_deltas) -> set[int]:
    """The stall-signature heuristic, shared by the incident builder
    below and the hedge trigger (``runtime/server.py::_hedge_suspects``):
    ranks the evidence points at — members that went quiet (the
    ``/healthz`` staleness rule), ranks a promoted tail's excess
    attributes to (``slow_rank`` annotations), and lease-expiry owners
    whose ``leases_expired_by{owner=}`` cell grew inside the window
    (the stalled worker itself). Inputs are all optional — each caller
    feeds what its window actually has."""
    suspects: set[int] = set()
    for r in stale_ranks or ():
        suspects.add(int(r))
    for j in tails or ():
        if "slow_rank" in j:
            suspects.add(j["slow_rank"])
    for key, v in (counter_deltas or {}).items():
        if key.startswith(LEASE_EXPIRY_PREFIX) and v > 0:
            try:
                suspects.add(int(key[len(LEASE_EXPIRY_PREFIX):-1]))
            except ValueError:
                pass
    return suspects


# ---------------------------------------------------------------- incidents


def build_incident(server, engine: SloEngine, transition: dict,
                   now: float) -> dict:
    """Snapshot the evidence for a page-severity FIRING, on the master's
    reactor: the violating (job, type)'s tail journeys (with the
    slow-stage + profiler-window annotations), the responsible ranks'
    dominant stacks over the firing window, the merged metrics delta
    over the burn window, suspect ranks, and the epoch-stamped fleet
    topology. Pure read — the caller writes it via flight.py."""
    from adlb_tpu_torch.obs.metrics import safe_copy
    from adlb_tpu_torch.obs.ops_server import annotate_tails
    from adlb_tpu_torch.obs.profile import window_of

    name = transition["name"]
    o = next((x for x in engine.objectives if x["name"] == name), {})
    job, typ = transition.get("job", 0), transition.get("type", -1)
    tails = [
        j for j in safe_copy(server._tails_fleet)
        if j.get("job", 0) == job and j.get("type", -1) == typ
    ]
    tails = annotate_tails(server, tails[-16:])  # bounded, newest last
    # suspect ranks: where the evidence points (the shared heuristic —
    # the hedge trigger consumes the same function per scan window)
    alert_row = next(
        (a for a in engine.alerts_pub if a["name"] == name), {})
    window_s = float(o.get("window_s") or 60.0)
    delta = engine.ring.window_delta(window_s, now)
    suspects = suspect_ranks(
        alert_row.get("stale_ranks"), tails, delta.get("counters")
    )
    # profiler join: each responsible rank's dominant stacks over the
    # monotonic windows the firing interval crossed (windows are
    # clock-aligned, so alert timestamps index them directly — the same
    # join /trace/tails does per journey, driven by an alert instead)
    fast_s = float(o.get("fast_s") or 2.0)
    fired_at = transition.get("at", now)
    w0, w1 = window_of(fired_at - fast_s), window_of(now)
    from adlb_tpu_torch.obs.ops_server import rank_windows

    span_ranks = {s[1] for j in tails for s in j.get("spans") or ()}
    stacks: dict[str, list] = {}
    for r in sorted(span_ranks | suspects | {server.rank}):
        agg: dict = {}
        for w in rank_windows(server, r):
            if w0 <= w["id"] <= w1:
                for k, v in w["stacks"].items():
                    agg[k] = agg.get(k, 0) + v
        if agg:
            stacks[str(r)] = sorted(
                agg.items(), key=lambda kv: -kv[1])[:5]
    return {
        "incident": name,
        "at": round(now, 6),
        "wall_time": time.time(),
        "job": job,
        "type": typ,
        "severity": transition.get("severity", "page"),
        "transition": dict(transition),
        "objective": dict(o),
        "alert": dict(alert_row),
        "suspect_ranks": sorted(suspects),
        "tails": tails,
        "stacks": stacks,
        "metrics_delta": delta,
        # burn-window hedge activity (launched/won/fenced/vetoed cells):
        # a page should show at a glance whether tail hedging was
        # already absorbing the straggler before the alert fired
        "hedges": {
            k: v for k, v in delta.get("counters", {}).items()
            if k.startswith("hedges_")
        },
        "epoch": server.world.epoch,
        "fleet": server.fleet_doc(),
    }
