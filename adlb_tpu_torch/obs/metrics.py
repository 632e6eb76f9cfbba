"""Per-rank metrics registry: counters, gauges, log-bucket histograms.

One :class:`Registry` per rank, written by every layer that has something
to count — the transport (per-tag message/byte counters, send/recv
latency), the server reactor (puts/reserves/rfrs/pushes, queue-depth
gauges), the balancer engine (round duration, plan age, pairs emitted)
and the client. Reads happen from other threads (the ops endpoint, the
flight recorder), so the design rules are:

* **instrument creation** is locked (get-or-create may race between the
  reactor and transport reader threads);
* **updates** are plain attribute writes/adds — unlocked. CPython's GIL
  makes each individual ``+=`` on the hot path cheap; a torn read by a
  scraper costs at most one sample of skew. A few instruments have two
  writer threads (the reactor and the in-server balancer thread both
  send on one endpoint, so they share per-tag tx counters and the
  ``send_s`` histogram) — an interleaved ``+=`` can drop an increment
  there. That bounded undercount is accepted by design: metrics must
  never serialize the data plane behind a lock.

Histograms use **fixed log buckets** (geometric bounds precomputed at
creation, reference STAT_TIME_ON_Q-style fixed tables) so observation is
one bisect + one integer add, and merging across ranks is elementwise.

A bounded :class:`Timeseries` (ring of ``(t, value)`` samples) backs the
queue-depth timelines the flight recorder dumps — the per-server
wq/rq-depth history that diagnosing a hung or flat-wait world needs.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from collections import deque
from typing import Iterable, Optional

# default latency bucket geometry: 1 us .. ~17 min in x4 steps
_DEF_BASE = 1e-6
_DEF_MULT = 4.0
_DEF_NBUCKETS = 16

# summary-style point quantiles emitted next to the cumulative buckets
_QUANTILES = ("0.5", "0.95", "0.99")


class Counter:
    """Monotone counter. ``inc`` is a plain add — see module docstring."""

    __slots__ = ("v",)

    def __init__(self) -> None:
        self.v = 0

    def inc(self, n: int = 1) -> None:
        self.v += n


class Gauge:
    """Point-in-time value (queue depth, backlog, bytes held)."""

    __slots__ = ("v",)

    def __init__(self) -> None:
        self.v = 0.0

    def set(self, v: float) -> None:
        self.v = v


class Histogram:
    """Fixed-log-bucket histogram: counts[i] = observations <= bounds[i],
    with one overflow bucket; plus sum/count for rate math."""

    __slots__ = ("bounds", "counts", "sum", "n")

    def __init__(
        self,
        base: float = _DEF_BASE,
        mult: float = _DEF_MULT,
        nbuckets: int = _DEF_NBUCKETS,
    ) -> None:
        self.bounds = tuple(base * mult**i for i in range(nbuckets))
        self.counts = [0] * (nbuckets + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, x: float) -> None:
        # bisect_left: an observation EQUAL to a bound belongs in that
        # bound's bucket (le = <=, Prometheus semantics)
        self.counts[bisect_left(self.bounds, x)] += 1
        self.sum += x
        self.n += 1

    def quantile(self, q: float) -> float:
        """Within-bucket linearly interpolated quantile at ``q`` (0..1)
        — still log-bucket coarse between bucket edges, but sharp enough
        for the point-quantile /metrics lines and the tail-promotion p99
        threshold (Prometheus ``histogram_quantile`` semantics)."""
        return quantile_of(self.bounds, self.counts, self.n, q)


def quantile_of(bounds, counts, n: int, q: float) -> float:
    """Interpolated quantile shared by live Histograms and merged
    snapshot dicts (the fleet /metrics, /jobs stage-latency views, and
    the tail-promotion thresholds): linear within the bucket the target
    rank lands in (lower edge 0 for the first bucket). A quantile in
    the +Inf overflow bucket answers the highest finite bound —
    Prometheus ``histogram_quantile`` convention; ``inf`` would poison
    every threshold compare downstream."""
    if n == 0:
        return 0.0
    target = q * n
    seen = 0.0
    for i, c in enumerate(counts):
        prev = seen
        seen += c
        if seen >= target and c > 0:
            if i >= len(bounds):
                return bounds[-1] if bounds else float("inf")
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = min(max((target - prev) / c, 0.0), 1.0)
            return lo + (bounds[i] - lo) * frac
    return bounds[-1] if bounds else float("inf")


class Timeseries:
    """Bounded ring of (t, value) samples — the queue-depth timeline."""

    __slots__ = ("_ring",)

    def __init__(self, capacity: int = 2048) -> None:
        self._ring: deque[tuple[float, float]] = deque(maxlen=capacity)

    def append(self, t: float, v: float) -> None:
        self._ring.append((t, v))

    def samples(self) -> list[tuple[float, float]]:
        return safe_copy(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


def safe_copy(seq) -> list:
    """Copy a deque/list whose owner thread may be appending concurrently:
    appends are atomic, but iterating a mutating deque raises — retry.
    Shared by the timeline samplers and the flight recorder's ring copy."""
    for _ in range(8):
        try:
            return list(seq)
        except RuntimeError:
            continue
    return []


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


class Registry:
    """One rank's metric store. Instruments are created on first use and
    cached by (name, labels); hot paths should hold the returned object
    instead of re-looking it up per event."""

    def __init__(self, rank: int = -1) -> None:
        self.rank = rank
        self._lock = threading.Lock()
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._hists: dict[tuple, Histogram] = {}
        self._series: dict[str, Timeseries] = {}

    # -- get-or-create ------------------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(k, Counter())
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(k, Gauge())
        return g

    def histogram(
        self,
        name: str,
        base: float = _DEF_BASE,
        mult: float = _DEF_MULT,
        nbuckets: int = _DEF_NBUCKETS,
        **labels,
    ) -> Histogram:
        k = _key(name, labels)
        h = self._hists.get(k)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(k, Histogram(base, mult, nbuckets))
        return h

    def timeseries(self, name: str, capacity: int = 2048) -> Timeseries:
        s = self._series.get(name)
        if s is None:
            with self._lock:
                s = self._series.setdefault(name, Timeseries(capacity))
        return s

    # -- reads ---------------------------------------------------------------

    def value(self, name: str, **labels) -> float:
        """Current counter (or gauge) value; 0 when never touched."""
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is not None:
            return c.v
        g = self._gauges.get(k)
        return g.v if g is not None else 0

    def sum_counter(self, name: str) -> float:
        """Sum of a counter over all its label sets (e.g. all tags)."""
        with self._lock:  # creation may resize the dict mid-iteration
            items = list(self._counters.items())
        return sum(c.v for (n, _), c in items if n == name)

    def labelled(self, name: str) -> dict[str, float]:
        """One counter family's current values keyed the snapshot way
        (``name{a=b}``; the bare cell keys as ``name``) — the hedge
        trigger's in-window ``leases_expired_by`` growth memo, without
        paying for a full snapshot per scan."""
        with self._lock:
            items = list(self._counters.items())
        out: dict[str, float] = {}
        for (n, labels), c in items:
            if n != name:
                continue
            if labels:
                out[name + "{" + ",".join(
                    f"{a}={b}" for a, b in labels) + "}"] = c.v
            else:
                out[name] = c.v
        return out

    def _stable_items(self) -> tuple[list, list, list, list]:
        """Consistent item lists for cross-thread readers (the ops scrape
        / flight dump): instrument *creation* holds the lock, so copying
        under it guarantees the dicts don't resize mid-iteration. Values
        keep updating — a scrape sees each metric within one update of
        live, which is the contract."""
        with self._lock:
            return (
                list(self._counters.items()),
                list(self._gauges.items()),
                list(self._hists.items()),
                list(self._series.items()),
            )

    def snapshot(self) -> dict:
        """JSON-able dump of everything — the flight recorder's metrics
        section and the cross-rank merge input."""

        def lk(k: tuple) -> str:
            name, labels = k
            if not labels:
                return name
            return name + "{" + ",".join(f"{a}={b}" for a, b in labels) + "}"

        counters, gauges, hists, series = self._stable_items()
        return {
            "rank": self.rank,
            "counters": {lk(k): c.v for k, c in sorted(counters)},
            "gauges": {lk(k): g.v for k, g in sorted(gauges)},
            "histograms": {
                lk(k): {
                    "bounds": list(h.bounds),
                    "counts": list(h.counts),
                    "sum": h.sum,
                    "count": h.n,
                }
                for k, h in sorted(hists)
            },
            "series": {
                name: [[round(t, 6), v] for t, v in s.samples()]
                for name, s in sorted(series)
            },
        }

    @staticmethod
    def merge(snapshots: Iterable[dict]) -> dict:
        """Elementwise merge of :meth:`snapshot` dicts from many ranks:
        counters and histogram cells sum; gauges keep per-rank identity by
        gaining a ``rank=`` label (a summed queue depth across ranks is a
        different metric than each rank's depth)."""
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        hists: dict[str, dict] = {}
        for snap in snapshots:
            r = snap.get("rank", -1)
            for k, v in snap.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
            for k, v in snap.get("gauges", {}).items():
                sep = "," if k.endswith("}") else "{"
                base = k[:-1] if k.endswith("}") else k
                gauges[f"{base}{sep}rank={r}}}"] = v
            for k, h in snap.get("histograms", {}).items():
                agg = hists.get(k)
                if agg is None or len(agg["counts"]) != len(h["counts"]):
                    hists[k] = {
                        "bounds": list(h["bounds"]),
                        "counts": list(h["counts"]),
                        "sum": h["sum"],
                        "count": h["count"],
                    }
                else:
                    agg["counts"] = [
                        a + b for a, b in zip(agg["counts"], h["counts"])
                    ]
                    agg["sum"] += h["sum"]
                    agg["count"] += h["count"]
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    # -- text exposition -----------------------------------------------------

    def expose(self, prefix: str = "adlb_") -> str:
        """Prometheus-style text exposition of this registry (the ops
        endpoint's ``/metrics`` body; aggregates are appended by the
        caller). Counter names gain ``_total``; every sample carries a
        ``rank`` label."""
        out: list[str] = []
        base_labels = {"rank": str(self.rank)} if self.rank >= 0 else {}

        def fmt(name: str, labels: dict, v) -> str:
            lab = {**base_labels, **labels}
            ls = ",".join(f'{a}="{b}"' for a, b in sorted(lab.items()))
            return f"{prefix}{name}{{{ls}}} {v}" if ls else f"{prefix}{name} {v}"

        seen_types: set[str] = set()

        def typ(name: str, t: str) -> None:
            if name not in seen_types:
                seen_types.add(name)
                out.append(f"# TYPE {prefix}{name} {t}")

        counters, gauges, hists, _ = self._stable_items()
        for (name, labels), c in sorted(counters):
            typ(name + "_total", "counter")
            out.append(fmt(name + "_total", dict(labels), c.v))
        for (name, labels), g in sorted(gauges):
            typ(name, "gauge")
            out.append(fmt(name, dict(labels), g.v))
        for (name, labels), h in sorted(hists):
            typ(name, "histogram")
            lab = dict(labels)
            cum = 0
            for i, c in enumerate(h.counts):
                cum += c
                le = f"{h.bounds[i]:.9g}" if i < len(h.bounds) else "+Inf"
                out.append(fmt(name + "_bucket", {**lab, "le": le}, cum))
            out.append(fmt(name + "_sum", dict(labels), round(h.sum, 9)))
            out.append(fmt(name + "_count", dict(labels), h.n))
            # point quantiles alongside the cumulative buckets (summary-
            # style compat lines for dashboards that read p50/p95/p99
            # directly; within-bucket interpolated, like
            # Histogram.quantile)
            for q in _QUANTILES:
                out.append(
                    fmt(name, {**lab, "quantile": q},
                        f"{h.quantile(float(q)):.9g}")
                )
        return "\n".join(out) + "\n"

    # -- fleet gossip (delta snapshots) --------------------------------------

    def delta_snapshot(self, last: dict) -> dict:
        """Changed-instruments-only snapshot for the SS_OBS_SYNC gossip:
        ``last`` is the caller-held per-instrument memo of what was last
        shipped (mutated in place). Values are CUMULATIVE — the receiver
        overwrites per-key, so a lost-and-reconnected stream heals on
        the next change rather than drifting. Histograms ship whole on
        any change (cells are elementwise-merged downstream)."""

        def lk(k: tuple) -> str:
            name, labels = k
            if not labels:
                return name
            return name + "{" + ",".join(f"{a}={b}" for a, b in labels) + "}"

        counters, gauges, hists, _ = self._stable_items()
        lc = last.setdefault("c", {})
        lg = last.setdefault("g", {})
        lh = last.setdefault("h", {})
        out: dict = {}
        dc = {}
        for k, c in counters:
            key = lk(k)
            if lc.get(key) != c.v:
                lc[key] = dc[key] = c.v
        if dc:
            out["counters"] = dc
        dg = {}
        for k, g in gauges:
            key = lk(k)
            if lg.get(key) != g.v:
                lg[key] = dg[key] = g.v
        if dg:
            out["gauges"] = dg
        dh = {}
        for k, h in hists:
            key = lk(k)
            if lh.get(key) != h.n:
                lh[key] = h.n
                dh[key] = {
                    "bounds": list(h.bounds),
                    "counts": list(h.counts),
                    "sum": h.sum,
                    "count": h.n,
                }
        if dh:
            out["histograms"] = dh
        return out


class SnapshotRing:
    """Bounded ring of timestamped MERGED registry snapshots — the
    windowed-rate substrate under the SLO engine (obs/slo.py).

    The servers gossip CUMULATIVE counters/histogram cells; a burn-rate
    objective needs *windowed* rates ("errors over the last 30 s", "p99
    of the units closed in the last 5 s"). Appending the master's merged
    view once per evaluation tick makes any window a two-snapshot
    subtraction: the newest entry minus the newest entry at least
    ``window_s`` old. Deltas are clamped at zero because membership
    churn shrinks the merge (a retired server's snapshot is popped, so
    fleet sums can step DOWN without any event having un-happened).

    A young ring answers with the span it actually covers — ``span_s``
    rides every delta so the caller can rate-normalize honestly instead
    of dividing a 3-second delta by a 300-second window."""

    __slots__ = ("_ring",)

    def __init__(self, capacity: int = 600) -> None:
        self._ring: deque[tuple[float, dict]] = deque(maxlen=capacity)

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def grow(self, capacity: int) -> None:
        """Re-bound the ring (a later objective may need a longer
        window); shrinking is refused — a live window must not lose its
        far edge mid-evaluation."""
        if capacity > (self._ring.maxlen or 0):
            self._ring = deque(self._ring, maxlen=capacity)

    def append(self, t: float, merged: dict) -> None:
        self._ring.append((t, merged))

    def latest(self) -> Optional[tuple[float, dict]]:
        return self._ring[-1] if self._ring else None

    def baseline(self, window_s: float, now: float) -> \
            Optional[tuple[float, dict]]:
        """The window's far edge: the NEWEST entry at least ``window_s``
        old, else the oldest available (young ring). None when empty."""
        entries = safe_copy(self._ring)
        if not entries:
            return None
        cut = now - window_s
        best = entries[0]
        for t, snap in entries:
            if t <= cut:
                best = (t, snap)
            else:
                break
        return best

    def counter_delta(self, key: str, window_s: float,
                      now: float) -> tuple[float, float]:
        """(delta, span_s) of one merged-counter key over the window;
        delta clamps at 0 (see class docstring)."""
        cur = self.latest()
        base = self.baseline(window_s, now)
        if cur is None or base is None or cur[0] <= base[0]:
            return 0.0, 0.0
        d = cur[1].get("counters", {}).get(key, 0) - \
            base[1].get("counters", {}).get(key, 0)
        return max(d, 0.0), cur[0] - base[0]

    def hist_delta(self, key: str, window_s: float, now: float) -> \
            Optional[tuple[list, list, int, float]]:
        """(bounds, counts_delta, n_delta, span_s) of one merged
        histogram over the window — the input quantile_of turns into a
        windowed p99. Cells clamp at 0 elementwise; None when the
        histogram never appeared (or changed bucket geometry)."""
        cur = self.latest()
        base = self.baseline(window_s, now)
        if cur is None:
            return None
        h = cur[1].get("histograms", {}).get(key)
        if h is None:
            return None
        span = 0.0
        counts = list(h["counts"])
        n = h["count"]
        if base is not None and base[0] < cur[0]:
            span = cur[0] - base[0]
            hb = base[1].get("histograms", {}).get(key)
            if hb is not None and len(hb["counts"]) == len(counts):
                counts = [max(a - b, 0) for a, b in
                          zip(counts, hb["counts"])]
                n = max(n - hb["count"], 0)
        return list(h["bounds"]), counts, n, span

    def window_delta(self, window_s: float, now: float) -> dict:
        """The full merged-metrics delta over the window (changed
        counters + histograms with closes in-window, latest gauges) —
        the ``metrics_delta`` section of an incident bundle."""
        cur = self.latest()
        base = self.baseline(window_s, now)
        if cur is None:
            return {"span_s": 0.0, "counters": {}, "gauges": {},
                    "histograms": {}}
        bc = base[1].get("counters", {}) if base else {}
        bh = base[1].get("histograms", {}) if base else {}
        counters = {}
        for k, v in cur[1].get("counters", {}).items():
            d = v - bc.get(k, 0)
            if d > 0:
                counters[k] = d
        hists = {}
        for k, h in cur[1].get("histograms", {}).items():
            prev = bh.get(k)
            counts, n = list(h["counts"]), h["count"]
            if prev is not None and len(prev["counts"]) == len(counts):
                counts = [max(a - b, 0) for a, b in
                          zip(counts, prev["counts"])]
                n = max(n - prev["count"], 0)
            if n > 0:
                hists[k] = {"bounds": list(h["bounds"]),
                            "counts": counts, "count": n}
        return {
            "span_s": round(cur[0] - base[0], 3) if base else 0.0,
            "counters": counters,
            "gauges": dict(cur[1].get("gauges", {})),
            "histograms": hists,
        }


def _prom_key(key: str) -> tuple[str, dict]:
    """Split a snapshot label-key (``name{a=b,c=d}`` / ``name``) back
    into (name, labels) for re-exposition."""
    if not key.endswith("}"):
        return key, {}
    name, _, rest = key.partition("{")
    labels = {}
    for pair in rest[:-1].split(","):
        a, _, b = pair.partition("=")
        labels[a] = b
    return name, labels


def expose_merged(merged: dict, prefix: str = "adlb_fleet_") -> str:
    """Prometheus-style exposition of a :meth:`Registry.merge` result —
    the master's FLEET view on ``/metrics``: counters and histogram
    cells are fleet sums, gauges keep the per-rank label merge() gave
    them. Same line shapes as :meth:`Registry.expose` (counters gain
    ``_total``; histograms emit ``_bucket``/``_sum``/``_count`` plus the
    point-quantile compat lines)."""
    out: list[str] = []

    def fmt(name: str, labels: dict, v) -> str:
        if not labels:
            return f"{prefix}{name} {v}"
        ls = ",".join(f'{a}="{b}"' for a, b in sorted(labels.items()))
        return f"{prefix}{name}{{{ls}}} {v}"

    for key, v in sorted(merged.get("counters", {}).items()):
        name, labels = _prom_key(key)
        out.append(fmt(name + "_total", labels, v))
    for key, v in sorted(merged.get("gauges", {}).items()):
        name, labels = _prom_key(key)
        out.append(fmt(name, labels, v))
    for key, h in sorted(merged.get("histograms", {}).items()):
        name, labels = _prom_key(key)
        bounds, counts = h["bounds"], h["counts"]
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            le = f"{bounds[i]:.9g}" if i < len(bounds) else "+Inf"
            out.append(fmt(name + "_bucket", {**labels, "le": le}, cum))
        out.append(fmt(name + "_sum", labels, round(h["sum"], 9)))
        out.append(fmt(name + "_count", labels, h["count"]))
        for q in _QUANTILES:
            out.append(fmt(
                name, {**labels, "quantile": q},
                f"{quantile_of(bounds, counts, h['count'], float(q)):.9g}",
            ))
    return "\n".join(out) + ("\n" if out else "")


def attach(ep, registry: Optional[Registry]) -> None:
    """Point an endpoint's transport instrumentation at ``registry``
    (both the TCP and in-proc endpoints check ``self.metrics``). First
    attachment wins — a Server and a Client never share an endpoint, so
    this only guards double-init."""
    if registry is not None and getattr(ep, "metrics", None) is None:
        ep.metrics = registry
