"""Closed-loop fleet controller: the "act" layer of sense → decide → act.

The obs plane gives the master a merged fleet registry and tail-promoted
journeys (sense); the SLO engine (``obs/slo.py``) turns them into a durable alert
lifecycle (decide); the membership plane leaves the actuators — server scale-out/in
through the membership plane, per-tenant quota throttling through the
job machinery — waiting for a brain. This module closes the loop: a
master-side :class:`Controller` rides the obs tick exactly like the SLO
engine, watches the fleet signals (memory pressure per rank, put-backoff
counts, lease ages, per-job queue depth/age, FIRING alerts), and drives
the existing actuators under **explicit hysteresis**:

* **per-action cooldowns** — after an action (or a dry-run would-act),
  its cooldown key is stamped for ``control_cooldown_s``; a flapping
  metric produces at most one action per cooldown window. ``scale_out``
  and ``scale_in`` SHARE one key, so the controller can never bounce a
  shard out and back in inside a window; throttles key per tenant.
* **fleet-size bounds** — ``control_min_servers`` /
  ``control_max_servers`` (0 = unbounded) are hard rails: a rule that
  would cross them records outcome ``bounded`` and does nothing.
* **epoch-churn hold** — membership epoch bumps freeze actions for the
  same grace window the SLO engine freezes alert state (an enacted
  scale-out's own join churn thus self-holds the controller while the
  new shard warms).
* **dry-run** (``control_dry_run=True``) — every decision is computed,
  recorded, and cooldown-paced exactly as live, but outcome is
  ``dry_run`` and no actuator is touched.

**Every decision is a record** — inputs → rule → action → outcome —
appended to a bounded history the ops endpoint serves at
``GET /control`` (and the reactor mirrors into the flight recorder).
``POST /control`` tweaks the live policy (thresholds, bounds, cooldown,
dry_run) without a restart.

Decision rules (deliberately few, explicit, and unit-testable —
:func:`Controller.evaluate` is a pure function of ``(now, inputs)`` plus
the controller's own hysteresis state):

* ``mem_pressure`` — the worst rank's ``nbytes / max_malloc_per_server``
  crossed ``control_scaleout_pressure`` → **scale_out** (hot rank
  named).
* ``slo_firing`` — a page-severity alert is FIRING while jobs hold
  backlog → **scale_out**.
* ``tenant_hog`` — memory is hot AND one unthrottled non-default tenant
  holds more than half the fleet's queued bytes → **throttle** it (cap
  its quota at ~its current footprint; the put path answers
  ``ADLB_BACKOFF`` beyond that). The pre-throttle quota is remembered;
  when pressure recedes below ``control_scalein_pressure`` the tenant is
  **unthrottled** (quota restored, -1 encodes unlimited).
* ``fleet_idle`` — every rank's pressure is below
  ``control_scalein_pressure``, nothing is firing, no job holds
  backlog, and the fleet is above both ``control_min_servers`` and the
  drain-safety floor of 2 → **scale_in** (newest shard drains through
  the zero-loss promote path).

Threading: ``evaluate``/``update_policy`` run on the master's reactor
thread only; the ops HTTP thread reads ``history`` / ``status_pub`` /
``policy_doc()``, which are swapped or append-only (``safe_copy`` on the
reading side), the same discipline as the SLO engine's published views.

An unconfigured world (``control=False``, the default) constructs no
Controller, starts no extra work on the tick, and mints no metrics —
frame-identical to a pre-controller build.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

# decision outcomes (append-only vocabulary, like the SLO alert states)
ACT = "act"  # returned to the reactor, which enacts and
# rewrites to "enacted" / "error"
DRY_RUN = "dry_run"
HELD = "held"  # epoch-churn hold window open
COOLDOWN = "cooldown"  # this action's key acted too recently
BOUNDED = "bounded"  # min/max server rail refused it

# mutable-policy keys POST /control may touch (everything else 400s)
_POLICY_KEYS = (
    "dry_run", "min_servers", "max_servers", "cooldown_s",
    "scaleout_pressure", "scalein_pressure", "throttle_frac",
)


def parse_policy(doc: dict, base: Optional[dict] = None) -> dict:
    """Validate + normalize a policy dict (Config knobs at construction
    and POST /control bodies go through the same gate). Raises
    ValueError with an operator-readable message — the ops route
    answers 400."""
    if not isinstance(doc, dict):
        raise ValueError(f"policy must be a dict, got {type(doc).__name__}")
    unknown = set(doc) - set(_POLICY_KEYS)
    if unknown:
        raise ValueError(f"unknown policy keys {sorted(unknown)}")
    pol = dict(base or {})
    for k in _POLICY_KEYS:
        if k in doc:
            pol[k] = doc[k]
    pol["dry_run"] = bool(pol.get("dry_run", False))
    pol["min_servers"] = int(pol.get("min_servers", 1))
    pol["max_servers"] = int(pol.get("max_servers", 0))
    pol["cooldown_s"] = float(pol.get("cooldown_s", 10.0))
    pol["scaleout_pressure"] = float(pol.get("scaleout_pressure", 0.85))
    pol["scalein_pressure"] = float(pol.get("scalein_pressure", 0.30))
    pol["throttle_frac"] = float(pol.get("throttle_frac", 0.5))
    if pol["min_servers"] < 1:
        raise ValueError("min_servers must be >= 1")
    if pol["max_servers"] < 0:
        raise ValueError("max_servers must be >= 0")
    if pol["max_servers"] and pol["max_servers"] < pol["min_servers"]:
        raise ValueError("max_servers, when bounded, must be >= "
                         "min_servers")
    if pol["cooldown_s"] < 0:
        raise ValueError("cooldown_s must be >= 0")
    if not (0.0 < pol["scaleout_pressure"] <= 1.0):
        raise ValueError("scaleout_pressure must be in (0, 1]")
    if not (0.0 <= pol["scalein_pressure"] < pol["scaleout_pressure"]):
        raise ValueError(
            "scalein_pressure must be in [0, scaleout_pressure)")
    if not (0.0 < pol["throttle_frac"] <= 1.0):
        raise ValueError("throttle_frac must be in (0, 1]")
    return pol


class Controller:
    """Master-side decision engine. One instance per master server,
    created at init when ``Config(control=True)``."""

    def __init__(self, policy: dict, eval_interval: float = 1.0,
                 now: Optional[float] = None) -> None:
        self.policy = parse_policy(policy)
        self.eval_interval = max(eval_interval, 1e-3)
        self.started_at = time.monotonic() if now is None else now
        self.actions_total = 0  # enacted only (dry-run stays 0)
        self.history: deque = deque(maxlen=256)
        self.status_pub: dict = {}
        # hysteresis state
        self._cooldowns: dict[str, float] = {}  # key -> until
        self._epoch: Optional[int] = None
        self._hold_until = 0.0
        # throttled tenants: jid -> pre-throttle quota_bytes (0 meant
        # unlimited; the restore encodes it as -1 on the update op)
        self._throttled: dict[int, int] = {}
        # last recorded (rule -> outcome): suppresses the repeat spam of
        # a rule stuck in the same suppressed outcome every tick
        self._last_outcome: dict[str, str] = {}

    @property
    def dry_run(self) -> bool:
        return bool(self.policy["dry_run"])

    # -- policy --------------------------------------------------------------

    def policy_doc(self) -> dict:
        return dict(self.policy)

    def update_policy(self, doc: dict) -> dict:
        """POST /control: merge a validated tweak into the live policy.
        Swap-published (a fresh dict) so HTTP readers never see a
        half-applied update."""
        self.policy = parse_policy(doc, base=self.policy)
        return dict(self.policy)

    # -- churn hysteresis ----------------------------------------------------

    def note_epoch(self, epoch: int, now: float) -> None:
        """Membership change: freeze actions for a grace period — the
        SLO engine's hold, applied to actuators instead of alert state.
        An enacted scale-out's own join bumps the epoch, so the
        controller self-holds while the new shard warms up."""
        if self._epoch is not None and epoch != self._epoch:
            self._hold_until = now + max(4.0 * self.eval_interval, 2.0)
        self._epoch = epoch

    # -- decisions -----------------------------------------------------------

    @staticmethod
    def _cooldown_key(action: dict) -> str:
        kind = action["kind"]
        if kind in ("scale_out", "scale_in"):
            return "scale"  # shared: never bounce a shard out-then-in
        if kind in ("throttle", "unthrottle"):
            return f"throttle:{action.get('job')}"
        return kind

    def _decide(self, now: float, rule: str, inputs: dict, action: dict,
                held: bool, bound: Optional[str] = None) -> dict:
        key = self._cooldown_key(action)
        if held:
            outcome = HELD
        elif bound is not None:
            outcome = BOUNDED
        elif now < self._cooldowns.get(key, 0.0):
            outcome = COOLDOWN
        else:
            # stamp the cooldown for dry-run too: the decision stream
            # must pace exactly like a live controller would
            self._cooldowns[key] = now + self.policy["cooldown_s"]
            outcome = DRY_RUN if self.dry_run else ACT
        d = {
            "at": round(now, 3),
            "rule": rule,
            "inputs": inputs,
            "action": action,
            "outcome": outcome,
        }
        if bound is not None:
            d["bound"] = bound
        return d

    def evaluate(self, now: float, inputs: dict) -> list[dict]:
        """One tick: run the rules over ``inputs`` and return the
        decision records that are new this tick (a rule stuck in the
        same suppressed outcome is recorded once, not every tick).
        Records with outcome ``act`` are the caller's to enact — it
        rewrites their outcome to ``enacted``/``error`` in place (the
        history holds the same dicts).

        ``inputs`` (all optional, zero-defaults):
        ``live_servers`` int; ``pressure`` {rank: frac-of-cap};
        ``firing`` int (page-severity FIRING alerts);
        ``jobs`` {jid: {"depth", "bytes", "oldest_age_s", "backoffs",
        "quota_bytes", "state"}}; ``backoffs`` int (fleet total);
        ``oldest_lease_s`` float; ``epoch`` int.
        """
        if inputs.get("epoch") is not None:
            self.note_epoch(int(inputs["epoch"]), now)
        held = now < self._hold_until
        pol = self.policy
        live = int(inputs.get("live_servers", 0) or 0)
        pressure: dict = inputs.get("pressure") or {}
        worst = max(pressure.values(), default=0.0)
        jobs: dict = inputs.get("jobs") or {}
        backlog = sum(int(j.get("depth", 0) or 0) for j in jobs.values())
        firing = int(inputs.get("firing", 0) or 0)
        decisions: list[dict] = []

        def hot_rank() -> Optional[int]:
            return max(pressure, key=pressure.get) if pressure else None

        # ---- scale_out: mem_pressure, then slo_firing
        if worst >= pol["scaleout_pressure"]:
            decisions.append(self._decide(
                now, "mem_pressure",
                {"worst_pressure": round(worst, 4),
                 "threshold": pol["scaleout_pressure"],
                 "live_servers": live},
                {"kind": "scale_out", "hot_rank": hot_rank()},
                held=held,
                bound="max_servers" if pol["max_servers"]
                and live >= pol["max_servers"] else None,
            ))
        elif firing > 0 and backlog > 0:
            decisions.append(self._decide(
                now, "slo_firing",
                {"firing": firing, "backlog": backlog,
                 "live_servers": live},
                {"kind": "scale_out", "hot_rank": hot_rank()},
                held=held,
                bound="max_servers" if pol["max_servers"]
                and live >= pol["max_servers"] else None,
            ))

        # ---- tenant throttling: hog under pressure; release when calm
        total_bytes = sum(
            int(j.get("bytes", 0) or 0) for j in jobs.values())
        if worst >= pol["scaleout_pressure"] and total_bytes > 0:
            for jid, j in sorted(jobs.items()):
                jb = int(j.get("bytes", 0) or 0)
                if (
                    jid != 0
                    and jid not in self._throttled
                    and j.get("state", "running") == "running"
                    and not int(j.get("quota_bytes", 0) or 0)
                    and jb > pol["throttle_frac"] * total_bytes
                ):
                    # cap the hog near its current footprint: it keeps
                    # what it queued, the put path backpressures growth
                    quota = max(jb, 1)
                    d = self._decide(
                        now, "tenant_hog",
                        {"job": jid, "job_bytes": jb,
                         "total_bytes": total_bytes,
                         "worst_pressure": round(worst, 4)},
                        {"kind": "throttle", "job": jid,
                         "quota_bytes": quota},
                        held=held,
                    )
                    if d["outcome"] in (ACT, DRY_RUN):
                        self._throttled[jid] = int(
                            j.get("quota_bytes", 0) or 0)
                    decisions.append(d)
                    break  # one tenant per tick
        elif self._throttled and worst <= pol["scalein_pressure"]:
            jid = sorted(self._throttled)[0]
            prev = self._throttled[jid]
            d = self._decide(
                now, "pressure_recovered",
                {"job": jid, "worst_pressure": round(worst, 4),
                 "restore_quota": prev},
                {"kind": "unthrottle", "job": jid,
                 # -1 = restore unlimited (the jobs.apply update op's
                 # encoding; 0 would mean "leave unchanged")
                 "quota_bytes": prev if prev else -1},
                held=held,
            )
            if d["outcome"] in (ACT, DRY_RUN):
                self._throttled.pop(jid, None)
            decisions.append(d)

        # ---- scale_in: fleet idle, above the floor
        if (
            not decisions
            and worst <= pol["scalein_pressure"]
            and firing == 0
            and backlog == 0
            and live > max(pol["min_servers"], 2)
        ):
            decisions.append(self._decide(
                now, "fleet_idle",
                {"worst_pressure": round(worst, 4),
                 "threshold": pol["scalein_pressure"],
                 "live_servers": live,
                 "min_servers": pol["min_servers"]},
                {"kind": "scale_in"},
                held=held,
            ))

        # ---- record: actions always; suppressed outcomes only when
        # they CHANGE (a held/cooldown rule re-evaluated every tick must
        # not fill the history with identical rows)
        out: list[dict] = []
        seen_rules = set()
        for d in decisions:
            seen_rules.add(d["rule"])
            if d["outcome"] in (ACT, DRY_RUN) or \
                    self._last_outcome.get(d["rule"]) != d["outcome"]:
                self._last_outcome[d["rule"]] = d["outcome"]
                self.history.append(d)
                out.append(d)
        for rule in list(self._last_outcome):
            if rule not in seen_rules:
                del self._last_outcome[rule]
        return out

    # -- published status ----------------------------------------------------

    def publish(self, now: float, inputs: dict) -> None:
        """Swap the compact status doc the HTTP thread reads."""
        self.status_pub = {
            "at": round(now, 3),
            "held": now < self._hold_until,
            "hold_until": round(self._hold_until, 3),
            "cooldowns": {
                k: round(u - now, 3)
                for k, u in self._cooldowns.items() if u > now
            },
            "throttled": {
                str(j): q for j, q in sorted(self._throttled.items())
            },
            "live_servers": int(inputs.get("live_servers", 0) or 0),
            "worst_pressure": round(
                max((inputs.get("pressure") or {}).values(),
                    default=0.0), 4),
            "firing": int(inputs.get("firing", 0) or 0),
            "backoffs": int(inputs.get("backoffs", 0) or 0),
            "oldest_lease_s": round(
                float(inputs.get("oldest_lease_s", 0.0) or 0.0), 3),
        }
