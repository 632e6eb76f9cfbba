#!/usr/bin/env python3
"""Offline summarizer for flight-record JSON artifacts of the PyTorch port
(``adlb_tpu_torch``): ``scripts/obs_report.py`` with its import rewritten
to the port. It reads files and runs no world.

A dead world (abort, watchdog timeout, lost home server) leaves one
``flight-rank<R>-<reason>.json`` per rank in the flight directory
(``Config(flight_dir=...)`` / ``ADLB_FLIGHT_DIR``). This tool turns a
directory (or an explicit file list) of them into a post-mortem:

* per rank: role, dump reason, and the tail of its recent-event ring;
* a merged cross-rank **failure timeline**: structured rank_dead /
  lease_reclaimed / targeted_dropped / reconnect / abort events, ordered
  on reconstructed wall-clock time — the post-mortem narrative of who
  died, what was reclaimed where, and who reconnected;
* counter totals (puts/reserves/rfrs/pushes and per-tag message counts)
  summed across ranks, with the top talkers broken out;
* per-server wq/rq queue-depth timelines (min/max/last + a coarse
  sparkline) — the depth history that explains a hang or a flat wait.

With ``--journeys`` the inputs are unit-journey documents instead — the
JSON served by the master's ``/trace/units`` ops route (or any file
holding a ``{"journeys": [...]}`` doc / a bare journey list): prints a
per-stage latency table (p50/p99 by job/type) plus a text waterfall of
the N slowest sampled units (``--slowest N``, default 5).

With ``--tails`` the inputs are ``/trace/tails`` documents (tail-based
promotion, ``Config(trace_tail)``): prints one row per promoted
journey — why it was kept, which stage its excess attributes to, and
the dominant profiler stacks active on the responsible rank during
that stage's window — plus the usual waterfall of the slowest.

With ``--profile`` the inputs are ``/profile?format=json`` documents
(the continuous profiler, ``Config(profile_hz)``): prints top-N
self/cumulative frame tables of the merged fleet profile
(``--top N``, default 15) and, with ``--collapsed PATH``, writes the
flamegraph-compatible collapsed-stack file.

With ``--alerts`` the inputs are ``/alerts`` documents (the SLO engine,
``Config(slo=...)``): one row per objective's alert state (fast/slow
burn rates, degraded/churn-held flags) plus the transition history.

With ``--incidents`` the inputs are ``/incidents`` documents or the
``incident-*.json`` bundles themselves: per incident, the alert that
fired, the suspect ranks, the burn-window metrics delta, the dominant
stacks per responsible rank, and the violating tail journeys.

With ``--index`` the inputs are ``/flight`` inventory documents or a
raw flight directory: one row per post-mortem artifact / incident
bundle (kind, rank, reason, size, age).

Usage:  python scripts/obs_report_torch.py <flight-dir | flight-*.json ...>
        python scripts/obs_report_torch.py --json <...>   (merged record as JSON)
        python scripts/obs_report_torch.py --journeys trace_units.json
        python scripts/obs_report_torch.py --journeys --slowest 8 <file ...>
        python scripts/obs_report_torch.py --tails trace_tails.json
        python scripts/obs_report_torch.py --profile [--top 20]
                                     [--collapsed out.folded] profile.json
        python scripts/obs_report_torch.py --alerts alerts.json
        python scripts/obs_report_torch.py --incidents <flight-dir | file ...>
        python scripts/obs_report_torch.py --index <flight-dir | flight.json>
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from adlb_tpu_torch.obs.metrics import Registry  # noqa: E402

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 32) -> str:
    if not values:
        return ""
    if len(values) > width:  # resample by bucket max (spikes must show)
        step = len(values) / width
        values = [
            max(values[int(i * step): max(int((i + 1) * step), int(i * step) + 1)])
            for i in range(width)
        ]
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)), len(_SPARK) - 1)]
        for v in values
    )


def load(paths: list[str]) -> list[dict]:
    files: list[Path] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            files.extend(sorted(pp.glob("flight-*.json")))
        else:
            files.append(pp)
    docs = []
    for f in files:
        try:
            doc = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"skipping {f}: {e}", file=sys.stderr)
            continue
        doc["_file"] = str(f)
        docs.append(doc)
    return docs


def _dedup_by_process(docs: list[dict]) -> list[dict]:
    """One artifact per (rank, pid) — a rank can dump several artifacts
    (abort_initiated then abort_event, plus ops /dump), all carrying the
    SAME cumulative counters and timelines; merging every copy would
    double-count. Keep the latest snapshot per process."""
    best: dict[tuple, dict] = {}
    for d in docs:
        if "metrics" not in d:
            continue
        key = (d.get("rank"), d.get("pid"))
        cur = best.get(key)
        if cur is None or d.get("monotonic", 0) >= cur.get("monotonic", 0):
            best[key] = d
    return sorted(best.values(), key=lambda d: d.get("rank", 1 << 30))


def _dedup_metrics(docs: list[dict]) -> list[dict]:
    return [d["metrics"] for d in _dedup_by_process(docs)]


# structured failure events the runtime records with a fixed leading
# keyword (server._on_rank_dead / _resurrect / the failover machinery,
# client._send_retry / _apply_takeover, and the gray-failure surface:
# lease expiry/fencing, hang detection, dead-letter quarantine, and
# overload backpressure)
_FAILURE_PREFIXES = (
    "rank_dead", "lease_reclaimed", "targeted_dropped", "reconnect",
    "abort", "home server", "send to rank",
    "server_dead", "failover_promoted", "failover_lost", "home_takeover",
    "relay_consumed_on_failover", "replication",
    "lease_expired", "rank_hung", "unit_quarantined", "put_backoff",
    "fenced",
)


def failure_timeline(docs: list[dict]) -> list[tuple]:
    """Merge every rank's structured failure events onto one clock.

    Ring entries are stamped with each process's *monotonic* clock;
    ``wall_time - monotonic`` per artifact gives that process's boot
    epoch, so ``epoch + entry_ts`` puts all ranks on comparable wall
    time (skewed only by the clocks themselves). Returns
    ``[(wall_ts, rank, role, text), ...]`` sorted by time."""
    events: list[tuple] = []
    for d in _dedup_by_process(docs) or docs:
        epoch = d.get("wall_time", 0.0) - d.get("monotonic", 0.0)
        for ts, text in d.get("events", []):
            if text.startswith(_FAILURE_PREFIXES):
                events.append(
                    (epoch + ts, d.get("rank", -1), d.get("role", "?"),
                     text)
                )
    events.sort()
    return events


def report(docs: list[dict], tail: int = 8) -> list[str]:
    out: list[str] = []
    ranked = sorted(docs, key=lambda d: d.get("rank", 1 << 30))
    out.append(f"flight artifacts: {len(ranked)}")

    # -- per-rank last events ------------------------------------------------
    for d in ranked:
        rank, role = d.get("rank", "?"), d.get("role", "?")
        reason = d.get("reason", "")
        events = d.get("events", [])
        out.append(
            f"\nrank {rank} [{role}] reason={reason!r} "
            f"({len(events)} ring entries, {d['_file']})"
        )
        for ts, text in events[-tail:]:
            out.append(f"  [{ts:.6f}] {text}")

    # -- failure timeline (merged across ranks) ------------------------------
    timeline = failure_timeline(ranked)
    if timeline:
        out.append("\nfailure timeline (reconstructed wall clock):")
        for wall, rank, role, text in timeline:
            out.append(f"  [{wall:.3f}] rank {rank:>3} [{role}] {text}")

    # -- counter totals across ranks ----------------------------------------
    merged = Registry.merge(_dedup_metrics(ranked))
    if merged["counters"]:
        out.append("\ncounter totals (all ranks):")
        plain = {
            k: v for k, v in merged["counters"].items() if "{" not in k
        }
        for k, v in sorted(plain.items()):
            out.append(f"  {k:<28} {int(v)}")
        tags: dict[str, float] = {}
        for k, v in merged["counters"].items():
            if k.startswith("rx_msgs{") or k.startswith("tx_msgs{"):
                tags[k] = tags.get(k, 0) + v
        if tags:
            out.append("  top message flows:")
            for k, v in sorted(tags.items(), key=lambda kv: -kv[1])[:12]:
                out.append(f"    {k:<40} {int(v)}")

    # -- queue-depth timelines (one per server process) ----------------------
    any_series = False
    for d in _dedup_by_process(ranked):
        series = d.get("metrics", {}).get("series", {})
        for name in ("wq_depth", "rq_depth"):
            samples = series.get(name)
            if not samples:
                continue
            if not any_series:
                out.append("\nqueue-depth timelines (per server rank):")
                any_series = True
            vals = [v for _, v in samples]
            t0, t1 = samples[0][0], samples[-1][0]
            out.append(
                f"  rank {d.get('rank', '?'):>3} {name:<8} "
                f"n={len(vals):<5} min={min(vals):<6g} max={max(vals):<6g} "
                f"last={vals[-1]:<6g} span={t1 - t0:>7.2f}s "
                f"{sparkline(vals)}"
            )
    return out


# ------------------------------------------------------- journey report


def _pctl(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over raw per-journey samples (exact — the
    offline tool sees the spans themselves, not log buckets)."""
    if not sorted_vals:
        return 0.0
    i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def load_journeys(paths: list[str]) -> list[dict]:
    """Accept /trace/units response docs, bare journey lists, or flight
    dirs holding either as *.json files."""
    files: list[Path] = []
    for p in paths:
        pp = Path(p)
        files.extend(sorted(pp.glob("*.json")) if pp.is_dir() else [pp])
    out: list[dict] = []
    for f in files:
        try:
            doc = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"skipping {f}: {e}", file=sys.stderr)
            continue
        if isinstance(doc, dict):
            doc = doc.get("journeys", [])
        out.extend(j for j in doc if isinstance(j, dict) and j.get("spans"))
    return out


def journey_report(journeys: list[dict], slowest: int = 5) -> list[str]:
    out = [f"journeys: {len(journeys)}"]
    ends: dict[str, int] = {}
    for j in journeys:
        ends[j.get("end", "?")] = ends.get(j.get("end", "?"), 0) + 1
    out.append("ends: " + ", ".join(
        f"{k}={v}" for k, v in sorted(ends.items())
    ))

    # -- per-stage latency table (p50/p99 by job/type) -----------------------
    # stage latency = time to REACH the stage from the previous span,
    # the same attribution the live unit_stage_s histograms use
    cells: dict[tuple, list[float]] = {}
    totals: dict[tuple, list[float]] = {}
    for j in journeys:
        key = (j.get("job", 0), j.get("type", -1))
        spans = j["spans"]
        totals.setdefault(key, []).append(
            j.get("total_s", spans[-1][2] - spans[0][2])
        )
        prev_t = spans[0][2]
        for stage, _rank, t in spans[1:]:
            cells.setdefault(key + (stage,), []).append(max(t - prev_t, 0.0))
            prev_t = t
    if cells:
        out.append("\nper-stage latency (ms) by job/type:")
        out.append(
            f"  {'job':>4} {'type':>5} {'stage':<11} {'n':>6} "
            f"{'p50':>9} {'p99':>9} {'max':>9}"
        )
        for (job, typ, stage), vals in sorted(cells.items()):
            vals.sort()
            out.append(
                f"  {job:>4} {typ:>5} {stage:<11} {len(vals):>6} "
                f"{_pctl(vals, 0.50) * 1e3:>9.3f} "
                f"{_pctl(vals, 0.99) * 1e3:>9.3f} "
                f"{vals[-1] * 1e3:>9.3f}"
            )
        for (job, typ), vals in sorted(totals.items()):
            vals.sort()
            out.append(
                f"  {job:>4} {typ:>5} {'TOTAL':<11} {len(vals):>6} "
                f"{_pctl(vals, 0.50) * 1e3:>9.3f} "
                f"{_pctl(vals, 0.99) * 1e3:>9.3f} "
                f"{vals[-1] * 1e3:>9.3f}"
            )

    # -- waterfall of the N slowest units ------------------------------------
    ranked = sorted(
        journeys,
        key=lambda j: j.get("total_s",
                            j["spans"][-1][2] - j["spans"][0][2]),
        reverse=True,
    )[:slowest]
    if ranked:
        out.append(f"\nslowest {len(ranked)} sampled units (waterfall):")
    width = 40
    for j in ranked:
        spans = j["spans"]
        t0, t1 = spans[0][2], spans[-1][2]
        span_s = (t1 - t0) or 1e-9
        out.append(
            f"  unit trace_id={j.get('trace_id')} job={j.get('job', 0)} "
            f"type={j.get('type', -1)} end={j.get('end')} "
            f"total={span_s * 1e3:.3f} ms"
        )
        prev_t = t0
        for stage, rank, t in spans:
            off = int((prev_t - t0) / span_s * width)
            ln = max(int((t - prev_t) / span_s * width), 0)
            bar = " " * off + ("·" if ln == 0 else "█" * ln)
            out.append(
                f"    {stage:<11} rank {rank:>3} "
                f"+{(t - prev_t) * 1e3:>9.3f} ms |{bar:<{width + 1}}|"
            )
            prev_t = t
    return out


# ------------------------------------------------------- tail report


def tails_report(journeys: list[dict], slowest: int = 5) -> list[str]:
    """One row per promoted tail journey: the retention reasons, the
    stage the excess attributes to, and the dominant profiler stacks on
    the responsible rank during that stage's window (annotations are
    computed server-side by the /trace/tails join)."""
    out = [f"tail journeys: {len(journeys)}"]
    whys: dict[str, int] = {}
    for j in journeys:
        for w in j.get("why") or ("?",):
            whys[w] = whys.get(w, 0) + 1
    out.append("promoted because: " + ", ".join(
        f"{k}={v}" for k, v in sorted(whys.items())
    ))
    out.append(
        f"\n  {'trace_id':>16} {'job':>4} {'type':>5} {'end':<12} "
        f"{'total_ms':>9} {'slow stage':<11} {'rank':>4} {'excess_ms':>9}"
    )
    ranked = sorted(journeys, key=lambda j: -j.get("total_s", 0.0))
    for j in ranked:
        out.append(
            f"  {j.get('trace_id', 0):>16} {j.get('job', 0):>4} "
            f"{j.get('type', -1):>5} {j.get('end', '?'):<12} "
            f"{j.get('total_s', 0.0) * 1e3:>9.3f} "
            f"{j.get('slow_stage', '-'):<11} "
            f"{j.get('slow_rank', -1):>4} "
            f"{j.get('excess_s', 0.0) * 1e3:>9.3f}"
        )
        for stack, n in (j.get("stacks") or [])[:3]:
            out.append(f"      [{n:>4} samples] {stack}")
    out.append("")
    out.extend(journey_report(journeys, slowest=slowest)[2:])
    return out


# --------------------------------------------- alerts / incidents / index


def load_docs(paths: list[str], glob: str = "*.json") -> list[dict]:
    """Generic JSON doc loader (files or dirs), for the /alerts,
    /incidents and /flight response shapes."""
    files: list[Path] = []
    for p in paths:
        pp = Path(p)
        files.extend(sorted(pp.glob(glob)) if pp.is_dir() else [pp])
    out: list[dict] = []
    for f in files:
        try:
            doc = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"skipping {f}: {e}", file=sys.stderr)
            continue
        if isinstance(doc, dict):
            doc["_file"] = str(f)
            out.append(doc)
    return out


def alerts_report(docs: list[dict]) -> list[str]:
    """Render /alerts documents: one row per objective's alert state
    (burn rates, degraded flag), then the transition history."""
    out: list[str] = []
    for doc in docs:
        alerts = doc.get("alerts") or []
        out.append(
            f"slo engine: enabled={doc.get('enabled', False)} "
            f"objectives={len(doc.get('objectives') or [])} "
            f"firing={doc.get('firing', 0)}"
        )
        if alerts:
            out.append(
                f"\n  {'name':<24} {'state':<9} {'sev':<5} "
                f"{'burn_fast':>9} {'burn_slow':>9} {'fired':>6} {'flags'}"
            )
        for a in alerts:
            flags = []
            if a.get("degraded"):
                flags.append(f"degraded({a.get('stale_ranks')})")
            if a.get("held"):
                flags.append("churn-held")
            out.append(
                f"  {a.get('name', '?'):<24} {a.get('state', '?'):<9} "
                f"{a.get('severity', '?'):<5} "
                f"{a.get('burn_fast', 0.0):>9.3f} "
                f"{a.get('burn_slow', 0.0):>9.3f} "
                f"{a.get('fire_count', 0):>6} {' '.join(flags)}"
            )
        hist = doc.get("history") or []
        if hist:
            out.append("\ntransition history:")
            for t in hist:
                out.append(
                    f"  [{t.get('at', 0.0):.3f}] {t.get('name', '?')} "
                    f"{t.get('from', '?')} -> {t.get('to', '?')} "
                    f"sev={t.get('severity')} "
                    f"burn={t.get('burn_fast')}/{t.get('burn_slow')}"
                )
    return out


def incidents_report(docs: list[dict], slowest: int = 5) -> list[str]:
    """Render incident bundles (/incidents docs or incident-*.json
    artifacts): the alert that fired, the suspect ranks, the violating
    tails, and the dominant stacks per responsible rank."""
    bundles: list[dict] = []
    for doc in docs:
        if "incidents" in doc:
            bundles.extend(doc["incidents"])
        elif "incident" in doc:
            bundles.append(doc)
    out = [f"incidents: {len(bundles)}"]
    for b in bundles:
        tr = b.get("transition") or {}
        out.append(
            f"\nincident {b.get('incident', '?')} "
            f"sev={b.get('severity', '?')} job={b.get('job')} "
            f"type={b.get('type')} epoch={b.get('epoch')}"
        )
        out.append(
            f"  fired {tr.get('from', '?')} -> {tr.get('to', '?')} "
            f"burn={tr.get('burn_fast')}/{tr.get('burn_slow')} "
            f"degraded={tr.get('degraded', False)}"
        )
        out.append(f"  suspect ranks: {b.get('suspect_ranks')}")
        delta = b.get("metrics_delta") or {}
        out.append(
            f"  burn-window delta: span={delta.get('span_s')}s "
            f"counters={len(delta.get('counters') or {})} "
            f"histograms={len(delta.get('histograms') or {})}"
        )
        for rank, stacks in sorted((b.get("stacks") or {}).items()):
            out.append(f"  rank {rank} dominant stacks:")
            for stack, n in stacks[:3]:
                out.append(f"    [{n:>4} samples] {stack}")
        tails = b.get("tails") or []
        if tails:
            out.append(f"  violating tails ({len(tails)}):")
            out.extend("  " + ln for ln in
                       tails_report(tails, slowest=slowest)[2:])
    return out


def index_report(docs: list[dict]) -> list[str]:
    """Render /flight inventory documents: one row per artifact."""
    out: list[str] = []
    for doc in docs:
        arts = doc.get("artifacts") or []
        out.append(
            f"flight dir {doc.get('flight_dir')}: {len(arts)} artifacts"
        )
        if arts:
            out.append(
                f"  {'kind':<9} {'rank':>4} {'reason':<28} "
                f"{'bytes':>8} {'age_s':>8}  file"
            )
        for a in arts:
            rank = a.get("rank")
            out.append(
                f"  {a.get('kind', '?'):<9} "
                f"{'-' if rank is None else rank:>4} "
                f"{a.get('reason', '?'):<28} {a.get('bytes', 0):>8} "
                f"{a.get('age_s', 0.0):>8.1f}  {a.get('file')}"
            )
    return out


# ----------------------------------------------------- profile report


def load_profiles(paths: list[str]) -> dict:
    """Merge /profile?format=json documents (or bare {stack: count}
    dicts) from files/dirs into one {stack: count} map."""
    files: list[Path] = []
    for p in paths:
        pp = Path(p)
        files.extend(sorted(pp.glob("*.json")) if pp.is_dir() else [pp])
    merged: dict[str, int] = {}
    for f in files:
        try:
            doc = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"skipping {f}: {e}", file=sys.stderr)
            continue
        stacks = doc.get("merged", doc) if isinstance(doc, dict) else {}
        for k, v in stacks.items():
            if isinstance(v, (int, float)):
                merged[k] = merged.get(k, 0) + int(v)
    return merged


def profile_report(stacks: dict, top: int = 15) -> list[str]:
    """Top-N frames by self and by cumulative samples. Self = samples
    whose stack ENDS at the frame; cumulative = samples whose stack
    contains it (deduped per stack, so recursion cannot double-count)."""
    total = sum(stacks.values())
    out = [f"profile: {len(stacks)} folded stacks, {total} samples"]
    self_c: dict[str, int] = {}
    cum_c: dict[str, int] = {}
    for stack, n in stacks.items():
        frames = stack.split(";")
        self_c[frames[-1]] = self_c.get(frames[-1], 0) + n
        for fr in set(frames):
            cum_c[fr] = cum_c.get(fr, 0) + n
    for title, table in (("self", self_c), ("cumulative", cum_c)):
        out.append(f"\ntop {top} frames by {title} samples:")
        out.append(f"  {'samples':>8} {'%':>6}  frame")
        for fr, n in sorted(table.items(), key=lambda kv: -kv[1])[:top]:
            pct = 100.0 * n / total if total else 0.0
            out.append(f"  {n:>8} {pct:>5.1f}%  {fr}")
    return out


def main(argv: list[str]) -> int:
    as_json = "--json" in argv
    paths = [a for a in argv if not a.startswith("-")]

    def opt(name, default, cast):
        if name not in argv:
            return default
        val = argv[argv.index(name) + 1]
        paths[:] = [a for a in paths if a != val]
        return cast(val)

    slowest = opt("--slowest", 5, int)
    top = opt("--top", 15, int)
    collapsed = opt("--collapsed", None, str)
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    if "--journeys" in argv or "--tails" in argv:
        journeys = load_journeys(paths)
        if not journeys:
            print("no journeys found", file=sys.stderr)
            return 1
        if as_json:
            print(json.dumps({"journeys": journeys}))
            return 0
        rep = tails_report if "--tails" in argv else journey_report
        print("\n".join(rep(journeys, slowest=slowest)))
        return 0
    if "--alerts" in argv:
        docs = load_docs(paths)
        if as_json:
            print(json.dumps({"docs": docs}))
            return 0
        print("\n".join(alerts_report(docs)))
        return 0
    if "--incidents" in argv:
        docs = load_docs(paths, glob="incident-*.json")
        if not docs:
            print("no incident bundles found", file=sys.stderr)
            return 1
        if as_json:
            print(json.dumps({"docs": docs}))
            return 0
        print("\n".join(incidents_report(docs, slowest=slowest)))
        return 0
    if "--index" in argv:
        # accept /flight response docs OR a raw flight dir (build the
        # inventory locally with the same filename contract)
        docs = []
        for p in list(paths):
            pp = Path(p)
            if pp.is_dir():
                import re
                import time

                arts = []
                now = time.time()
                for f in sorted(pp.glob("*.json")):
                    m = re.match(
                        r"(flight|incident)-(?:rank(\d+)-)?"
                        r"(.+?)-p(\d+)\.json$", f.name,
                    )
                    if m is None:
                        continue
                    kind, rank, slug, pid = m.groups()
                    st = f.stat()
                    arts.append({
                        "file": f.name,
                        "kind": ("incident" if kind == "incident"
                                 else "flight"),
                        "rank": int(rank) if rank is not None else None,
                        "reason": slug, "pid": int(pid),
                        "bytes": st.st_size,
                        "age_s": round(max(now - st.st_mtime, 0.0), 3),
                    })
                docs.append({"flight_dir": str(pp), "artifacts": arts})
            else:
                docs.extend(load_docs([p]))
        if as_json:
            print(json.dumps({"docs": docs}))
            return 0
        print("\n".join(index_report(docs)))
        return 0
    if "--profile" in argv:
        stacks = load_profiles(paths)
        if not stacks:
            print("no profile stacks found", file=sys.stderr)
            return 1
        if collapsed:
            Path(collapsed).write_text("".join(
                f"{k} {v}\n" for k, v in
                sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
            ))
            print(f"collapsed stacks written to {collapsed}")
        if as_json:
            print(json.dumps({"merged": stacks}))
            return 0
        print("\n".join(profile_report(stacks, top=top)))
        return 0
    docs = load(paths)
    if not docs:
        print("no flight artifacts found", file=sys.stderr)
        return 1
    if as_json:
        merged = Registry.merge(_dedup_metrics(docs))
        print(json.dumps({"artifacts": docs, "merged_counters": merged}))
        return 0
    print("\n".join(report(docs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
