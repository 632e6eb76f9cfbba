"""Periodic cluster-wide statistics (the reference's periodic-stats ring).

The reference's master server assembles, every ``periodic_log_interval``
seconds, a per-type × per-target work-queue histogram plus the waiting-
requester vector and put/resolved-reserve counters, circulates it around the
server ring via ``SS_PERIODIC_STATS`` where each server adds its own share,
and prints the summed result in ≤500-byte ``STAT_APS:`` chunks parsed offline
by ``scripts/get_stats.py`` (reference ``src/adlb.c:447-477,712-753,
2391-2465``; decoder ``scripts/get_stats.py:1-117``).

This module is the rebuild's equivalent: per-server contributions are plain
dicts carried by the same ring token pass; the master emits the aggregate as
chunked ``STAT_APS:`` lines (JSON payload split at ``CHUNK`` bytes for parity
with the reference's aprintf limit) through a swappable sink, and
:func:`parse_stat_lines` reassembles them — shared by the offline decoder and
the tests.
"""

from __future__ import annotations

import json
from typing import Iterable

from adlb_tpu_torch.runtime.sink import Sink

CHUNK = 500  # reference prints periodic stats in <=500-byte chunks

_SINK = Sink()
set_sink = _SINK.set
_emit = _SINK.emit


def contribution(server) -> dict:
    """One server's share of the periodic aggregate: wq histogram by
    (type, target bucket), rq length, cumulative put/resolved counters
    (reference assembles the same per-type × per-target table,
    ``src/adlb.c:447-477``)."""
    hist: dict[tuple[int, int], int] = {}
    for u in server.wq.units():
        key = (u.work_type, -1 if u.target_rank < 0 else u.target_rank)
        hist[key] = hist.get(key, 0) + 1
    return {
        "wq": [[t, tgt, n] for (t, tgt), n in sorted(hist.items())],
        "wq_count": server.wq.count,
        "rq": len(server.rq),
        "puts": int(server.metrics.value("puts")),
        "resolved": server.resolved_reserves,
        "nbytes": server.mem.curr,
    }


def aggregate(token: dict, now: float) -> dict:
    """Master-side sum of every server's contribution into the record the
    decoder consumes (reference sums around the ring then prints,
    ``src/adlb.c:2391-2465``)."""
    by_type: dict[int, dict[str, int]] = {}
    total = {"wq": 0, "rq": 0, "puts": 0, "resolved": 0, "nbytes": 0}
    for entry in token["entries"].values():
        for t, tgt, n in entry["wq"]:
            cell = by_type.setdefault(t, {"targeted": 0, "untargeted": 0})
            cell["targeted" if tgt >= 0 else "untargeted"] += n
        total["wq"] += entry["wq_count"]
        total["rq"] += entry["rq"]
        total["puts"] += entry["puts"]
        total["resolved"] += entry["resolved"]
        total["nbytes"] += entry["nbytes"]
    return {
        "seq": token["seq"],
        "t": round(now, 6),
        "trip_s": round(now - token["t0"], 6),
        "nservers": len(token["entries"]),
        "by_type": {str(t): c for t, c in sorted(by_type.items())},
        "total": total,
        "per_server": {
            str(r): {"wq": e["wq_count"], "rq": e["rq"], "nbytes": e["nbytes"]}
            for r, e in sorted(token["entries"].items())
        },
    }


def emit_stat_aps(record: dict) -> None:
    """Print one aggregate as chunked ``STAT_APS: seq=S part=I/N <chunk>``
    lines."""
    payload = json.dumps(record, separators=(",", ":"))
    parts = [payload[i : i + CHUNK] for i in range(0, len(payload), CHUNK)] or [""]
    for i, part in enumerate(parts):
        _emit(f"STAT_APS: seq={record['seq']} part={i + 1}/{len(parts)} {part}")


def parse_stat_lines(lines: Iterable[str]) -> list[dict]:
    """Reassemble chunked STAT_APS lines back into aggregate records —
    the in-library half of ``scripts/get_stats.py`` (reference decoder
    ``scripts/get_stats.py:1-117``)."""
    pending: dict[int, dict] = {}
    out: list[dict] = []
    for line in lines:
        idx = line.find("STAT_APS: ")
        if idx < 0:
            continue
        try:
            # "seq=S part=I/N <chunk>"
            fields = line[idx + len("STAT_APS: ") :].split(" ", 2)
            seq = int(fields[0].split("=", 1)[1])
            part_i, part_n = (int(x) for x in fields[1].split("=", 1)[1].split("/"))
            chunk = fields[2] if len(fields) > 2 else ""
        except (ValueError, IndexError):
            continue
        rec = pending.get(seq)
        if rec is None or rec["n"] != part_n or part_i in rec["parts"]:
            # a fresh record for a seq we were mid-assembly on (e.g. logs
            # from two runs concatenated): start over rather than mixing
            rec = pending[seq] = {"n": part_n, "parts": {}}
        rec["parts"][part_i] = chunk
        if len(rec["parts"]) == rec["n"]:
            payload = "".join(rec["parts"][i] for i in sorted(rec["parts"]))
            del pending[seq]
            try:
                out.append(json.loads(payload))
            except json.JSONDecodeError:
                continue
    out.sort(key=lambda r: r.get("seq", 0))
    return out


def summarize(records: list[dict]) -> list[dict]:
    """Per-period rates from consecutive cumulative counters — what the
    reference's offline decoder prints as its activity table."""
    rows: list[dict] = []
    prev = None
    for rec in records:
        row = {
            "seq": rec["seq"],
            "wq_total": rec["total"]["wq"],
            "rq_total": rec["total"]["rq"],
            "nbytes": rec["total"]["nbytes"],
            "by_type": rec["by_type"],
            "trip_s": rec["trip_s"],
        }
        if prev is not None:
            dt = rec["t"] - prev["t"]
            if dt > 0:
                row["puts_per_s"] = round(
                    (rec["total"]["puts"] - prev["total"]["puts"]) / dt, 2
                )
                row["resolved_per_s"] = round(
                    (rec["total"]["resolved"] - prev["total"]["resolved"]) / dt, 2
                )
        rows.append(row)
        prev = rec
    return rows
