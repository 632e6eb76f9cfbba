"""Live ops endpoint on the master server.

A localhost HTTP surface (``Config(ops_port=...)``) so an operator — or a
scraper — can interrogate a running world without touching the protocol
plane:

* ``GET /healthz`` — liveness + role summary (uptime, wq/rq depth,
  done/aborted flags) plus per-rank snapshot staleness from the
  SS_OBS_SYNC gossip (a wedged server's age grows before it EOFs); JSON.
* ``GET /metrics`` — Prometheus-style text exposition of the master's
  registry (per-tag message counters, queue-depth gauges, latency
  histograms), the ``adlb_fleet_*`` merged-fleet section (the master's
  registry + every gossiped per-rank snapshot through
  ``Registry.merge``) with per-rank seq/age provenance rows, and the
  **world aggregate**: the most recent STAT_APS record the
  periodic-stats ring delivered (enable with
  ``Config(periodic_log_interval=...)``), exposed as
  ``adlb_world_*``/``adlb_server_*`` samples stamped with the ring
  sequence number AND aged (``adlb_stat_aps_age_seconds``) so stale
  data is distinguishable from live.
* ``GET /trace/units`` — the fleet journey store (unit-lifecycle
  tracing, ``Config(trace_sample)``): closed per-unit journeys from
  every rank, summarizable offline with
  ``scripts/obs_report.py --journeys``. Supports ``?job=``, ``?type=``,
  ``?min_ms=`` and ``?limit=`` (newest N) query filters — the bounded
  store holds up to 4096 journeys, which is an unwieldy single body.
* ``GET /trace/tails`` — the TAIL store (``Config(trace_tail)``):
  journeys promoted at close because they blew the live per-(job,type)
  fleet p99 or ended anomalously (quarantined/dropped/lost/expired
  lease). Same query filters as ``/trace/units``. Each journey comes
  annotated with the stage that blew past its fleet-typical p50
  (``slow_stage``/``excess_s``) and, when the continuous profiler is
  armed, the dominant folded stacks active on the responsible rank
  during the window(s) that stage crossed (``stacks``) — the
  tail↔profile join. Render with ``scripts/obs_report.py --tails``.
* ``GET /profile`` — the merged fleet continuous profile
  (``Config(profile_hz)``): collapsed-stack text (flamegraph-ready;
  one ``role;[phase:..;]frames... count`` line per stack), or the full
  JSON document (per-rank stacks + sampling windows) with
  ``?format=json``. Render with ``scripts/obs_report.py --profile``.
* ``GET /dump`` — trigger a flight-record snapshot: returns the JSON doc
  inline and writes the artifact when a flight directory is configured.
* ``GET /deadletter`` — this server's dead-letter quarantine (units that
  exhausted ``Config(max_unit_retries)``): metadata + attempt counts,
  payloads hex-encoded and truncated to ``Config(ops_dump_bytes)``. The
  store is per-server; the ops endpoint runs on the master, so this is
  the master's shard — ``ctx.get_quarantined()`` is the world-wide view.
* ``/fleet`` — elastic membership (adlb_tpu_torch/runtime/membership.py):
  ``GET /fleet`` serves the live topology under the fleet epoch — every
  server with its state (live/joining/draining/drained/dead, extra =
  scale-out shard), every app rank with its home and state (attached =
  joined after bring-up), the detached-rank history, and any parked
  scale request (the autoscaler feed). ``POST /fleet/scale`` with
  ``{"dir": "out"}`` requests a new server shard; ``{"dir": "in"}``
  (optional ``"rank"``) drains one through the zero-loss promote path.
* ``/slo`` + ``/alerts`` + ``/incidents`` + ``/flight`` — the SLO plane
  (adlb_tpu_torch/obs/slo.py): ``POST /slo`` adds a declarative objective to
  the live engine (same schema as ``Config(slo=...)``);
  ``GET /alerts`` serves the per-objective alert rows (state machine
  PENDING→FIRING→RESOLVED, fast/slow burn rates, staleness-degraded
  flag) plus the transition history; ``GET /incidents`` the captured
  live incident bundles (tails + stacks + metrics delta + topology for
  each page-severity FIRING); ``GET /flight`` the flight-directory
  inventory (post-mortem artifacts and incident bundles with rank,
  reason, size, age) so captures are discoverable without shell access.
* ``/jobs`` — the service-mode control plane: ``GET /jobs`` lists the
  job table, ``GET /jobs/<id>`` one job's status, ``POST /jobs`` (JSON
  body ``{"name": ..., "quota_bytes": ...}``) submits a namespace, and
  ``POST /jobs/<id>/drain`` / ``POST /jobs/<id>/kill`` drive its
  lifecycle. Mutations are injected into the reactor thread via
  ``Server.ctl_request`` (the HTTP thread never touches protocol state
  directly) and fan out to the fleet as ``SS_JOB_CTL``.

The GET handlers only read plain attributes of the live ``Server``
object (GIL-consistent snapshots, same discipline as the metrics
registry), so they never block the reactor. Binding is 127.0.0.1-only
by design: this is an operator surface, not a public one.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def _stable_dict(d: dict) -> dict:
    """Copy a dict the reactor thread may be inserting into (the fleet
    snapshot/staleness ledgers): per-key VALUES are published by swap
    (never mutated in place), so a retried shallow copy of the outer
    dict is a consistent read. Same retry discipline as
    metrics.safe_copy."""
    for _ in range(8):
        try:
            return dict(d)
        except RuntimeError:
            continue
    return {}


def _world_agg_lines(agg: dict) -> list[str]:
    """STAT_APS aggregate -> exposition lines (the 'world-aggregated via
    the existing stats ring' half of /metrics)."""
    out = [
        "# world aggregate from the periodic stats ring (STAT_APS)",
        f"adlb_stat_aps_seq {agg['seq']}",
        f"adlb_stat_aps_trip_seconds {agg['trip_s']}",
        f"adlb_world_nservers {agg['nservers']}",
    ]
    total = agg["total"]
    for k in ("wq", "rq", "puts", "resolved", "nbytes"):
        out.append(f"adlb_world_{k}_total {total[k]}")
    for t, cell in agg["by_type"].items():
        out.append(
            f'adlb_world_wq_depth_by_type{{type="{t}",kind="untargeted"}} '
            f"{cell['untargeted']}"
        )
        out.append(
            f'adlb_world_wq_depth_by_type{{type="{t}",kind="targeted"}} '
            f"{cell['targeted']}"
        )
    for r, e in agg["per_server"].items():
        out.append(f'adlb_server_wq_depth{{rank="{r}"}} {e["wq"]}')
        out.append(f'adlb_server_rq_depth{{rank="{r}"}} {e["rq"]}')
        out.append(f'adlb_server_nbytes{{rank="{r}"}} {e["nbytes"]}')
    return out


def fleet_stage_p50(server) -> dict:
    """(stage, job, type) -> fleet-typical p50 from the merged
    unit_stage_s cells — the baseline each tail journey's per-stage
    deltas are judged against. Module-level so the SLO engine's
    incident builder (obs/slo.py) shares the exact join the
    /trace/tails view uses."""
    from adlb_tpu_torch.obs.metrics import Registry, quantile_of

    s = server
    merged = Registry.merge(
        [s.metrics.snapshot()] + list(_stable_dict(s._fleet_snaps).values())
    )["histograms"]
    out = {}
    for key, h in merged.items():
        if not key.startswith("unit_stage_s{"):
            continue
        lab = dict(
            kv.split("=", 1)
            for kv in key[len("unit_stage_s{"):-1].split(",")
        )
        try:
            out[(lab["stage"], int(lab["job"]), int(lab["type"]))] = \
                quantile_of(h["bounds"], h["counts"], h["count"], 0.5)
        except (KeyError, ValueError):
            continue
    return out


def rank_windows(server, rank: int) -> list:
    """A rank's sealed profiler windows: the master's own live from
    its owned sampler, every other rank's from the gossip ring —
    with an in-proc fallback: a single-interpreter world runs ONE
    process profiler whose samples cover every co-located rank's
    threads but are filed under the owner, so when nothing has ever
    gossiped windows (the profile plane is entirely local) the
    process profiler's windows ARE this rank's windows."""
    from adlb_tpu_torch.obs import profile as _profile
    from adlb_tpu_torch.obs.metrics import safe_copy

    s = server
    wins = s._prof_windows.get(rank)
    if wins is not None:
        return safe_copy(wins)
    if rank == s.rank and s._prof is not None:
        return safe_copy(s._prof.windows)
    if not s._prof_windows:
        p = s._prof or _profile.active()
        if p is not None:
            return safe_copy(p.windows)
    return []


def annotate_tails(server, journeys: list) -> list:
    """Annotate tail journeys with the stage their excess attributes to
    (the stage whose delta most exceeds the fleet-typical p50 —
    ``slow_stage``/``slow_rank``/``excess_s``) and, when the continuous
    profiler runs, the dominant folded stacks active on the responsible
    rank during the window(s) that stage crossed. The body behind
    ``GET /trace/tails``, shared with the incident bundles."""
    from adlb_tpu_torch.obs.profile import window_of

    p50 = fleet_stage_p50(server)
    out = []
    for j in journeys:
        j = dict(j)
        spans = j.get("spans") or []
        best = None  # (excess, stage, rank, t_prev, t)
        prev_t = spans[0][2] if spans else 0.0
        for stage, rank, t in spans[1:]:
            delta = max(t - prev_t, 0.0)
            excess = delta - p50.get(
                (stage, j.get("job", 0), j.get("type", -1)), 0.0
            )
            if best is None or excess > best[0]:
                best = (excess, stage, rank, prev_t, t)
            prev_t = t
        if best is not None and best[0] > 0:
            excess, stage, rank, t_a, t_b = best
            j["slow_stage"] = stage
            j["slow_rank"] = rank
            j["excess_s"] = round(excess, 6)
            # profiler join: sum the responsible rank's window
            # stacks over the window ids the slow interval crossed
            # (window ids are clock-aligned on the shared host
            # CLOCK_MONOTONIC, so span stamps index them directly)
            w0, w1 = window_of(t_a), window_of(t_b)
            stacks: dict = {}
            for w in rank_windows(server, rank):
                if w0 <= w["id"] <= w1:
                    for k, v in w["stacks"].items():
                        stacks[k] = stacks.get(k, 0) + v
            if stacks:
                j["stacks"] = sorted(
                    stacks.items(), key=lambda kv: -kv[1]
                )[:5]
        out.append(j)
    return out


class OpsServer:
    """Threaded HTTP listener owned by the master server's process.

    Started by ``Server.run()`` (master only) when ``cfg.ops_port`` is
    set; stopped in its ``finally``. ``port`` holds the actual bound port
    (``ops_port=0`` binds ephemeral — useful for tests on one host).
    """

    def __init__(self, server, port: int, host: str = "127.0.0.1") -> None:
        self.server = server
        self._t0 = None
        srv = self.server

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # the reactor's stderr is not a
                pass  # request log

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 — http.server contract
                from urllib.parse import parse_qs

                path, _, query = self.path.partition("?")
                q = {k: v[-1] for k, v in parse_qs(query).items()}
                try:
                    if path == "/healthz":
                        body = json.dumps(ops._healthz()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/metrics":
                        self._send(
                            200, ops._metrics().encode(),
                            "text/plain; version=0.0.4",
                        )
                    elif path == "/dump":
                        body = json.dumps(ops._dump()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/deadletter":
                        body = json.dumps(ops._deadletter()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/trace/units":
                        body = json.dumps(ops._trace_units(q)).encode()
                        self._send(200, body, "application/json")
                    elif path == "/trace/tails":
                        body = json.dumps(ops._trace_tails(q)).encode()
                        self._send(200, body, "application/json")
                    elif path == "/profile":
                        if q.get("format") == "json":
                            self._send(
                                200,
                                json.dumps(ops._profile_doc()).encode(),
                                "application/json",
                            )
                        else:
                            self._send(200, ops._profile_text().encode(),
                                       "text/plain")
                    elif path == "/fleet":
                        body = json.dumps(srv.fleet_doc()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/alerts":
                        body = json.dumps(ops._alerts()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/incidents":
                        body = json.dumps(ops._incidents(q)).encode()
                        self._send(200, body, "application/json")
                    elif path == "/flight":
                        body = json.dumps(ops._flight_index()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/control":
                        body = json.dumps(ops._control()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/jobs":
                        body = json.dumps(ops._jobs()).encode()
                        self._send(200, body, "application/json")
                    elif path.startswith("/jobs/"):
                        doc = ops._job_one(path.split("/")[2])
                        if doc is None:
                            self._send(404, b"no such job\n", "text/plain")
                        else:
                            self._send(200, json.dumps(doc).encode(),
                                       "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 — a scrape must
                    # never kill the listener thread
                    self._send(500, repr(e).encode(), "text/plain")

            def do_POST(self) -> None:  # noqa: N802
                path = self.path.split("?", 1)[0]
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(n) if n else b""
                    parts = [p for p in path.split("/") if p]
                    if path == "/dump":
                        # historical alias: POST /dump == GET /dump
                        body = json.dumps(ops._dump()).encode()
                        self._send(200, body, "application/json")
                    elif parts[:1] == ["jobs"] and len(parts) <= 3:
                        body = json.dumps(
                            ops._jobs_post(parts[1:], raw)
                        ).encode()
                        self._send(200, body, "application/json")
                    elif parts == ["fleet", "scale"]:
                        body = json.dumps(
                            ops._fleet_scale(raw)
                        ).encode()
                        self._send(200, body, "application/json")
                    elif parts == ["slo"]:
                        body = json.dumps(ops._slo_post(raw)).encode()
                        self._send(200, body, "application/json")
                    elif parts == ["control"]:
                        body = json.dumps(ops._control_post(raw)).encode()
                        self._send(200, body, "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except (KeyError, ValueError, IndexError) as e:
                    self._send(400, repr(e).encode(), "text/plain")
                except Exception as e:  # noqa: BLE001
                    self._send(500, repr(e).encode(), "text/plain")

        ops = self
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            daemon=True,
            name=f"adlb-ops-{srv.rank}",
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "OpsServer":
        import time

        self._t0 = time.monotonic()
        self._thread.start()
        return self

    def stop(self) -> None:
        try:
            if self._thread.is_alive():
                # shutdown() handshakes with serve_forever — calling it
                # on a never-started listener would block forever
                self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass

    # -- views ---------------------------------------------------------------

    def _healthz(self) -> dict:
        import time

        s = self.server
        now = time.monotonic()
        # per-rank snapshot staleness from the SS_OBS_SYNC gossip: a
        # wedged server stops heartbeating and its age grows — visible
        # here BEFORE its connections EOF. The master is age 0 (its own
        # registry is read live); ranks never heard from report seq 0
        # with age since the endpoint started.
        cadence = getattr(s.cfg, "obs_sync_interval", 0) or 0
        fleet_seen = _stable_dict(s._fleet_seen)
        ranks = {str(s.rank): {"seq": -1, "age_s": 0.0, "stale": False}}
        for r in list(s.world.server_ranks):
            if r == s.rank:
                continue
            if r in s._dead_servers or not s._is_live_member(r):
                # retired (dead/drained) or not-yet-live members must
                # not report stale forever — /fleet keeps the topology
                # history; staleness is a LIVE-member alarm
                continue
            seen = fleet_seen.get(r)
            if seen is None:
                age = round(now - (self._t0 or now), 3)
                seq = 0
            else:
                seq, t_at = seen
                age = round(now - t_at, 3)
            ranks[str(r)] = {
                "seq": seq,
                "age_s": age,
                "stale": bool(cadence) and age > 3.0 * cadence,
            }
        return {
            "ok": not s._aborted,
            "rank": s.rank,
            "role": "master" if s.is_master else "server",
            "uptime_s": round(now - (self._t0 or 0.0), 3),
            "wq": s.wq.count,
            "rq": len(s.rq),
            "nbytes": s.mem.curr,
            "done": s.done,
            "aborted": s._aborted,
            "no_more_work": s.no_more_work,
            "done_by_exhaustion": s.done_by_exhaustion,
            "nservers": s.world.nservers,
            "obs_sync_interval": cadence,
            "ranks": ranks,
            "stale_ranks": sorted(
                int(r) for r, e in ranks.items() if e["stale"]
            ),
        }

    def _metrics(self) -> str:
        import time

        from adlb_tpu_torch.obs.metrics import Registry, expose_merged

        s = self.server
        now = time.monotonic()
        body = s.metrics.expose()
        # ---- fleet view: the master's live registry merged with every
        # gossiped per-rank snapshot (counters/histogram cells sum,
        # gauges keep rank identity) — what Registry.merge computed
        # offline for post-mortems, served live
        fleet = [s.metrics.snapshot()] + list(
            _stable_dict(s._fleet_snaps).values()
        )
        body += "# fleet view: merged across gossiped rank snapshots\n"
        body += expose_merged(Registry.merge(fleet))
        # per-rank snapshot provenance: seq + age, so a scraper can tell
        # live rows from stale ones (the staleness /healthz alarms on)
        for r, (seq, t_at) in sorted(_stable_dict(s._fleet_seen).items()):
            body += (
                f'adlb_obs_snapshot_seq{{rank="{r}"}} {seq}\n'
                f'adlb_obs_snapshot_age_seconds{{rank="{r}"}} '
                f"{max(now - t_at, 0.0):.3f}\n"
            )
        agg = getattr(s, "last_aggregate", None)
        if agg is not None:
            body += "\n".join(_world_agg_lines(agg)) + "\n"
            # age-stamp the aggregate: it is the LAST ring tick's data,
            # and without an age a stalled ring is indistinguishable
            # from a live one
            body += (
                f"adlb_stat_aps_age_seconds "
                f"{max(now - s._last_aggregate_at, 0.0):.3f}\n"
            )
        return body

    @staticmethod
    def _filter_journeys(journeys: list, q: Optional[dict]) -> list:
        """Apply the ``?job= / ?type= / ?min_ms= / ?limit=`` query
        filters (limit keeps the NEWEST n; the stores append newest
        last). Unknown keys are ignored; malformed values raise
        ValueError, which the handler answers as a 500 with the repr."""
        if not q:
            return journeys
        if "job" in q:
            want = int(q["job"])
            journeys = [j for j in journeys if j.get("job", 0) == want]
        if "type" in q:
            want = int(q["type"])
            journeys = [j for j in journeys if j.get("type", -1) == want]
        if "min_ms" in q:
            floor_s = float(q["min_ms"]) / 1e3
            journeys = [
                j for j in journeys if j.get("total_s", 0.0) >= floor_s
            ]
        if "limit" in q:
            n = max(int(q["limit"]), 0)
            # negative-index slice: clamps when n exceeds the store
            # (journeys[len-n:] would wrap and DROP results instead)
            journeys = journeys[-n:] if n else []
        return journeys

    def _trace_units(self, q: Optional[dict] = None) -> dict:
        """The fleet journey store: every closed unit journey that
        reached the master (its own + the SS_OBS_SYNC gossip), newest
        last. Spans are (stage, rank, t_mono) triples; per-stage deltas
        are the same data the unit_stage_s histograms aggregate."""
        from adlb_tpu_torch.obs.metrics import safe_copy

        s = self.server
        journeys = self._filter_journeys(safe_copy(s._journeys_fleet), q)
        return {
            "rank": s.rank,
            "count": len(journeys),
            "journeys": journeys,
        }

    # -- tail store + the tail<->profile join --------------------------------

    def _trace_tails(self, q: Optional[dict] = None) -> dict:
        """The tail store (Config(trace_tail)): promoted journeys
        through :func:`annotate_tails` (slow-stage attribution + the
        tail<->profile window join, shared with the incident bundles)."""
        from adlb_tpu_torch.obs.metrics import safe_copy

        s = self.server
        journeys = annotate_tails(
            s, self._filter_journeys(safe_copy(s._tails_fleet), q)
        )
        return {"rank": s.rank, "count": len(journeys),
                "journeys": journeys}

    # -- continuous profile --------------------------------------------------

    def _profile_doc(self) -> dict:
        """The merged fleet profile: per-rank cumulative folded stacks
        (the master's own read live from its sampler, peers' from the
        SS_OBS_SYNC gossip), their elementwise-summed merge, and the
        per-rank sealed sampling windows (the tail-join inputs)."""
        from adlb_tpu_torch.obs.profile import merge_stacks

        s = self.server
        per_rank: dict[str, dict] = {}
        windows: dict[str, list] = {}
        if s._prof is not None:
            own = s._prof.snapshot()
            per_rank[str(s.rank)] = own["stacks"]
            windows[str(s.rank)] = own["win"]
        from adlb_tpu_torch.obs.metrics import safe_copy

        for r, stacks in sorted(_stable_dict(s._prof_fleet).items()):
            per_rank[str(r)] = dict(stacks)
        for r, wins in sorted(_stable_dict(s._prof_windows).items()):
            windows[str(r)] = safe_copy(wins)
        return {
            "rank": s.rank,
            "hz": getattr(s.cfg, "profile_hz", 0.0),
            "ranks": per_rank,
            "merged": merge_stacks(per_rank),
            "windows": windows,
        }

    def _profile_text(self) -> str:
        """Flamegraph-compatible collapsed-stack text of the merged
        fleet profile (one ``stack count`` line, heaviest first)."""
        from adlb_tpu_torch.obs.profile import collapsed_text

        return collapsed_text(self._profile_doc()["merged"])

    def _deadletter(self) -> dict:
        s = self.server
        cut = getattr(s.cfg, "ops_dump_bytes", 256)
        records = []
        for q in list(getattr(s, "quarantine", ())):
            payload = q.get("payload", b"")
            records.append(
                {
                    "seqno": q["seqno"],
                    "work_type": q["work_type"],
                    "prio": q["prio"],
                    "target_rank": q["target_rank"],
                    "answer_rank": q["answer_rank"],
                    "attempts": q["attempts"],
                    "server_rank": q["server_rank"],
                    "payload_len": len(payload),
                    # bounded hex (Config(ops_dump_bytes)) so a fat
                    # poison unit cannot blow up a scrape; the full
                    # payload stays retrievable in-band via
                    # ctx.get_quarantined()
                    "payload_hex": bytes(payload[:cut]).hex(),
                    # a fused member whose prefix lives on another
                    # server: payload is the suffix alone and the
                    # common handle says where the rest is
                    "suffix_only": bool(q.get("suffix_only")),
                    "common_seqno": q.get("common_seqno", -1),
                    "common_server_rank": q.get("common_server_rank", -1),
                }
            )
        return {"rank": s.rank, "count": len(records), "records": records}

    def _dump(self) -> dict:
        s = self.server
        s.flight.record("ops /dump requested")
        doc = s.flight.snapshot_doc(reason="ops")
        path = s.flight.dump_json(reason="ops")
        return {"artifact": path, "record": doc}

    # -- SLO / alerts / incidents --------------------------------------------

    def _alerts(self) -> dict:
        """The SLO engine's published state: objectives, per-objective
        alert rows (state, burn rates, degraded flag), and the recent
        transition history. All publish-by-swap reads — the engine runs
        on the reactor; this is the HTTP thread."""
        from adlb_tpu_torch.obs.metrics import safe_copy

        s = self.server
        eng = s._slo_engine
        if eng is None:
            return {"rank": s.rank, "enabled": False, "objectives": [],
                    "alerts": [], "firing": 0, "history": []}
        return {
            "rank": s.rank,
            "enabled": True,
            "objectives": list(eng.objectives),
            "alerts": eng.alerts_pub,
            "firing": eng.firing,
            "history": safe_copy(eng.history),
        }

    def _incidents(self, q: Optional[dict] = None) -> dict:
        """Captured live incident bundles, newest last (bounded ring;
        the durable copies live in flight_dir — see /flight).
        ``?limit=`` keeps the newest n."""
        from adlb_tpu_torch.obs.metrics import safe_copy

        s = self.server
        incidents = safe_copy(s._incidents)
        if q and "limit" in q:
            n = max(int(q["limit"]), 0)
            incidents = incidents[-n:] if n else []
        return {"rank": s.rank, "count": len(incidents),
                "incidents": incidents}

    def _flight_index(self) -> dict:
        """Inventory of the flight directory: every post-mortem artifact
        and incident bundle (filename, kind, rank, reason, size, age) so
        CI and operators discover captures without shelling into the
        box. Filenames encode rank/reason/pid (see obs/flight.py); the
        index parses, never re-reads, the JSON bodies."""
        import os
        import re
        import time

        s = self.server
        out_dir = s.flight.out_dir
        entries = []
        if out_dir and os.path.isdir(out_dir):
            now = time.time()
            for fn in sorted(os.listdir(out_dir)):
                m = re.match(
                    r"(flight|incident)-(?:rank(\d+)-)?(.+?)-p(\d+)\.json$",
                    fn,
                )
                if m is None:
                    continue
                kind, rank, slug, pid = m.groups()
                try:
                    st = os.stat(os.path.join(out_dir, fn))
                except OSError:
                    continue  # racing a concurrent atomic replace
                entries.append({
                    "file": fn,
                    "kind": "incident" if kind == "incident" else "flight",
                    "rank": int(rank) if rank is not None else None,
                    "reason": slug,
                    "pid": int(pid),
                    "bytes": st.st_size,
                    "age_s": round(max(now - st.st_mtime, 0.0), 3),
                })
        return {
            "rank": s.rank,
            "flight_dir": out_dir,
            "count": len(entries),
            "artifacts": entries,
        }

    def _slo_post(self, raw: bytes) -> dict:
        """POST /slo — add an objective to the live engine. Validated
        here first (a malformed body answers 400 from the HTTP thread),
        then normalized for real on the reactor, where the engine and
        its evaluation cadence live."""
        from adlb_tpu_torch.obs.slo import parse_objective

        body = json.loads(raw.decode() or "{}")
        parse_objective(body)  # 400 gate only; reactor re-normalizes
        return self.server.ctl_request({"op": "slo", "objective": body})

    # -- /control: the closed-loop controller --------------------------------

    def _control(self) -> dict:
        """The fleet controller's published state (adlb_tpu_torch/control):
        live policy, hold/cooldown status, and the decision history —
        every decision as inputs -> rule -> action -> outcome. All
        publish-by-swap reads (the controller runs on the reactor's obs
        tick; this is the HTTP thread), mirroring /alerts."""
        from adlb_tpu_torch.obs.metrics import safe_copy

        s = self.server
        ctl = getattr(s, "_controller", None)
        if ctl is None:
            return {"rank": s.rank, "enabled": False, "policy": {},
                    "decisions": [], "actions": 0}
        return {
            "rank": s.rank,
            "enabled": True,
            "dry_run": ctl.dry_run,
            "policy": ctl.policy_doc(),
            "status": ctl.status_pub,
            "actions": ctl.actions_total,
            "decisions": safe_copy(ctl.history),
        }

    def _control_post(self, raw: bytes) -> dict:
        """POST /control — live policy tweaks (cooldown, pressure
        thresholds, server bounds, dry_run). Validated and applied on
        the reactor, where the controller lives."""
        from adlb_tpu_torch.control.controller import parse_policy

        if getattr(self.server, "_controller", None) is None:
            raise ValueError(
                "controller not configured (Config(control=True))"
            )
        body = json.loads(raw.decode() or "{}")
        parse_policy(body)  # 400 gate only; reactor merges onto the live base
        return self.server.ctl_request({"op": "control", "policy": body})

    # -- /jobs control plane -------------------------------------------------

    def _jobs(self) -> dict:
        s = self.server
        return {
            "rank": s.rank,
            "jobs": [j.summary() for j in s.jobs.values()],
        }

    def _job_one(self, jid_str: str):
        jid = int(jid_str)
        job = self.server.jobs.get(jid)
        if job is None:
            return None
        doc = job.summary()
        doc.update(self._job_gauges(jid))
        return doc

    def _job_gauges(self, jid: int) -> dict:
        """Live per-job depth/bytes/age + stage-latency quantiles: the
        master's own queues read directly, every other rank's from its
        gossiped snapshot's ``job_*`` gauges and ``unit_stage_s``
        histogram cells (the item-3 autoscaler's sensor row)."""
        from adlb_tpu_torch.obs.metrics import quantile_of

        s = self.server
        import time

        now = time.monotonic()
        part = s.wq.part(jid)
        job = s.jobs.get(jid)
        depth = part.count if part is not None else 0
        nbytes = part.total_bytes if part is not None else 0
        age = max(
            (now - u.time_stamp for u in part.units()), default=0.0
        ) if part is not None else 0.0
        backoffs = job.backoffs if job is not None else 0
        per_rank = {
            str(s.rank): {
                "depth": depth, "bytes": nbytes, "age_s": round(age, 3),
                "backoffs": backoffs,
            }
        }
        jl = f"job={jid}"
        fleet_snaps = _stable_dict(s._fleet_snaps)
        for r, snap in fleet_snaps.items():
            g = snap.get("gauges", {})

            def cell(name: str) -> float:
                # gauge keys carry sorted labels: job_* have only {job=}
                return float(g.get(f"{name}{{{jl}}}", 0.0))

            d = cell("job_wq_depth")
            b = cell("job_wq_bytes")
            a = cell("job_oldest_age_s")
            bk = cell("job_backoffs")
            per_rank[str(r)] = {
                "depth": int(d), "bytes": int(b), "age_s": round(a, 3),
                "backoffs": int(bk),
            }
            depth += int(d)
            nbytes += int(b)
            age = max(age, a)
            backoffs += int(bk)
        # stage latencies: Registry.merge sums the unit_stage_s cells
        # across ranks (per full label set); what remains here is only
        # restricting to this job's label and folding the TYPE label
        # away so /jobs reports one row per stage
        from adlb_tpu_torch.obs.metrics import Registry

        merged = Registry.merge(
            [s.metrics.snapshot()] + list(fleet_snaps.values())
        )["histograms"]
        stages: dict = {}
        for key, h in merged.items():
            if not key.startswith("unit_stage_s{"):
                continue
            labels = key[len("unit_stage_s{"):-1].split(",")
            if jl not in labels:
                continue
            stage = next(
                (x.split("=", 1)[1] for x in labels
                 if x.startswith("stage=")), "?",
            )
            agg = stages.get(stage)
            if agg is None:
                stages[stage] = {
                    "bounds": list(h["bounds"]),
                    "counts": list(h["counts"]),
                    "sum": h["sum"], "count": h["count"],
                }
            elif len(agg["counts"]) == len(h["counts"]):
                agg["counts"] = [
                    a_ + b_ for a_, b_ in zip(agg["counts"], h["counts"])
                ]
                agg["sum"] += h["sum"]
                agg["count"] += h["count"]
        quota = job.quota_bytes if job is not None else 0
        return {
            "queue_depth": depth,
            "queued_bytes": nbytes,
            "oldest_age_s": round(age, 3),
            # quota state: the cap is PER SERVER, so pressure is
            # the WORST rank's used/quota — the signal the controller's
            # throttle rules and an operator's eyeball both want
            "quota_bytes": quota,
            "quota_used_frac": round(
                max(
                    (e["bytes"] / quota for e in per_rank.values()),
                    default=0.0,
                ), 4,
            ) if quota > 0 else 0.0,
            "backoffs_fleet": backoffs,
            "per_rank": per_rank,
            "stage_latency_s": {
                stage: {
                    "p50": quantile_of(a["bounds"], a["counts"],
                                       a["count"], 0.5),
                    "p99": quantile_of(a["bounds"], a["counts"],
                                       a["count"], 0.99),
                    "count": a["count"],
                }
                for stage, a in sorted(stages.items())
            },
        }

    def _fleet_scale(self, raw: bytes) -> dict:
        """POST /fleet/scale — elastic membership: ``{"dir": "out"}``
        requests a new server shard (spawned via the registered member
        spawner, or parked as a pending request feeding the autoscaler);
        ``{"dir": "in"}`` (optionally ``{"rank": N}``) drains a server
        through the zero-loss promote path. Serviced on the reactor via
        the same ctl inbox as /jobs."""
        body = json.loads(raw.decode() or "{}")
        direction = body.get("dir") or body.get("direction")
        if direction == "out":
            return self.server.ctl_request({"op": "scale_out"})
        if direction == "in":
            req = {"op": "scale_in"}
            if body.get("rank") is not None:
                req["rank"] = int(body["rank"])
            return self.server.ctl_request(req)
        raise ValueError('scale needs {"dir": "out"|"in"}')

    def _jobs_post(self, parts: list, raw: bytes) -> dict:
        """POST /jobs (submit), POST /jobs/<id> (live update: fair-share
        ``weight``, ``quota_bytes`` with -1 = unlimited), and
        POST /jobs/<id>/{drain,kill}: build a control request and hand
        it to the reactor thread."""
        s = self.server
        if not parts:  # POST /jobs — submit
            body = json.loads(raw.decode() or "{}")
            return s.ctl_request({
                "op": "submit",
                "name": str(body.get("name", "")),
                "quota_bytes": int(body.get("quota_bytes", 0) or 0),
            })
        jid, action = int(parts[0]), (parts[1] if len(parts) > 1 else "")
        if not action:  # POST /jobs/<id> — policy update
            body = json.loads(raw.decode() or "{}")
            req = {"op": "update", "job_id": jid,
                   "quota_bytes": int(body.get("quota_bytes", 0) or 0)}
            if body.get("weight") is not None:
                req["weight"] = float(body["weight"])
            return s.ctl_request(req)
        if action not in ("drain", "kill"):
            raise ValueError(f"unknown job action {action!r}")
        return s.ctl_request({"op": action, "job_id": jid})


def maybe_start(server, cfg, port=None) -> Optional[OpsServer]:
    """Start the ops endpoint iff this server is the master and a port is
    configured. ``port`` overrides ``cfg.ops_port`` — a promoted deputy
    rebinds on an ephemeral port (0) because the dead master's HTTP
    thread may still hold the configured one. Bind failures degrade to a
    warning — observability must never take the data plane down with it."""
    p = cfg.ops_port if port is None else port
    if not server.is_master or p is None:
        return None
    try:
        return OpsServer(server, p).start()
    except OSError as e:
        import sys

        print(
            f"[adlb ops] could not bind ops endpoint on port "
            f"{p}: {e!r}; continuing without it",
            file=sys.stderr,
        )
        return None
