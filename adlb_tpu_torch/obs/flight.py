"""Crash flight recorder: JSON post-mortem artifacts for dead worlds.

Extends the in-memory circular log (:class:`adlb_tpu_torch.runtime.debug.
FlightRecorder`, the reference's ``cblog``) with a durable JSON artifact:
when a rank dies — abort, watchdog timeout, lost home server — it writes
``flight-rank<R>-<reason>.json`` into the flight directory, carrying the
recent-event ring, a full metrics snapshot (counter totals, per-tag
message counts, the wq/rq depth timelines) and whatever role context the
caller adds. A chaos-soak failure then reads as a post-mortem instead of
demanding a rerun; ``scripts/obs_report.py`` summarizes the artifacts
offline.

Artifacts are opt-in: ``Config(flight_dir=...)`` or the
``ADLB_FLIGHT_DIR`` environment variable (the env var is how CI collects
them from worlds it did not configure). Disabled = the text dump through
the sink still happens, nothing is written.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

from adlb_tpu_torch.obs.metrics import safe_copy
from adlb_tpu_torch.runtime import debug as _debug

SCHEMA = 1


def _write_json(out_dir: str, filename: str, doc: dict) -> Optional[str]:
    """Atomic artifact write (tmp + rename, readers never see a torn
    file); returns the path, or None on failure — a post-mortem writer
    must never replace the original failure with an error of its own."""
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, filename)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except (OSError, TypeError, ValueError):
        return None


def resolve_flight_dir(cfg_value: Optional[str] = None) -> Optional[str]:
    """Explicit config wins; else the ADLB_FLIGHT_DIR env contract (how
    CI and the native daemons' Python wrappers opt whole worlds in);
    else disabled."""
    return cfg_value or os.environ.get("ADLB_FLIGHT_DIR") or None


def _slug(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", reason).strip("_") or "dump"


class FlightRecorder(_debug.FlightRecorder):
    """The debug-layer ring plus JSON artifact emission.

    ``record()`` stays one deque append; ``dump()`` keeps the sink text
    dump (the reference's abort behaviour, and what the existing tests
    assert) and *additionally* writes the JSON artifact when a flight
    directory is configured. ``metrics`` and ``context`` are attached by
    the owner (server/client) after construction.
    """

    def __init__(
        self,
        rank: int,
        capacity: int = 512,
        out_dir: Optional[str] = None,
        role: str = "server",
    ) -> None:
        super().__init__(rank, capacity)
        self.out_dir = resolve_flight_dir(out_dir)
        self.role = role
        self.metrics = None  # Registry, attached by the owner
        self.context: dict = {}  # static role context (world shape, cfg)
        self.last_artifact: Optional[str] = None

    # -- artifact ------------------------------------------------------------

    def _safe_entries(self) -> list:
        """Ring copy tolerant of a concurrent writer: /dump runs on the
        ops HTTP thread while the reactor keeps record()-ing."""
        return safe_copy(self._ring)

    def snapshot_doc(self, reason: str = "") -> dict:
        """The artifact body, also served live by the ops endpoint's
        ``/dump`` (which must work without a flight directory)."""
        doc = {
            "schema": SCHEMA,
            "rank": self.rank,
            "role": self.role,
            "reason": reason,
            "wall_time": time.time(),
            "monotonic": time.monotonic(),
            "pid": os.getpid(),
            "context": dict(self.context),
            "events": [
                [round(ts, 6), text] for ts, text in self._safe_entries()
            ],
        }
        if self.metrics is not None:
            doc["metrics"] = self.metrics.snapshot()
        return doc

    def dump_json(self, reason: str = "") -> Optional[str]:
        """Write the artifact; returns its path, or None when disabled or
        unwritable (never raises — see _write_json)."""
        if not self.out_dir:
            return None
        # pid in the name: successive worlds sharing one flight dir
        # (a CI suite, a chaos soak) are distinct OS processes per
        # rank, so their post-mortems must not overwrite each other;
        # within ONE process re-dumps of the same reason overwrite,
        # which keeps long soaks bounded
        path = _write_json(
            self.out_dir,
            f"flight-rank{self.rank}-{_slug(reason)}-p{os.getpid()}.json",
            self.snapshot_doc(reason),
        )
        if path is not None:
            self.last_artifact = path
        return path

    def dump(self, reason: str = "") -> None:
        super().dump(reason)  # sink text dump (tests/operators read this)
        self.dump_json(reason)


def write_incident(
    out_dir: Optional[str], name: str, doc: dict
) -> Optional[str]:
    """Live incident bundle writer (the SLO engine's page-severity
    FIRING capture): same atomic write + pid-suffix rule as the
    post-mortem artifacts, but an ``incident-`` prefix so ``/flight``
    and ``obs_report --index`` can tell dead-world post-mortems from
    live captures. Within one process, re-fires of the same alert
    overwrite — a flapping objective cannot fill the disk."""
    out_dir = resolve_flight_dir(out_dir)
    if not out_dir:
        return None
    return _write_json(
        out_dir,
        f"incident-{_slug(name)}-p{os.getpid()}.json",
        {"schema": SCHEMA, **doc},
    )


def write_artifact(
    out_dir: Optional[str], name: str, doc: dict
) -> Optional[str]:
    """One-off artifact writer for roles without a recorder (the debug
    watchdog dumping its aggregates on timeout, the balancer sidecar at
    exit). Same pid-suffix rule as dump_json: successive worlds sharing
    one flight dir must not overwrite each other's post-mortems."""
    out_dir = resolve_flight_dir(out_dir)
    if not out_dir:
        return None
    return _write_json(
        out_dir,
        f"flight-{_slug(name)}-p{os.getpid()}.json",
        {"schema": SCHEMA, "wall_time": time.time(), **doc},
    )
