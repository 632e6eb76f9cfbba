"""Continuous sampling profiler: folded stacks by thread role + phase.

The fleet's "why is the CPU busy" sensor (Google-Wide-Profiling-style):
an always-available, low-overhead sampling thread per process
(``Config(profile_hz)``, default 0 = off; 19 Hz recommended — a prime,
so it cannot phase-lock with the 20 ms balancer tick or the 50 ms
qmstat cadence) walks ``sys._current_frames()`` and folds each thread's
stack into a collapsed-stack counter::

    <role>;[phase:<p>;]<outer frame>;...;<inner frame>  ->  samples

* **role** — threads declare themselves via :func:`register_thread`
  ("reactor", "balancer", "heartbeat", "client", ...); undeclared
  threads fall back to their thread name. Registration is a plain dict
  write, safe to call whether or not a profiler is running.
* **phase** — the server reactor publishes a *phase marker*
  (:meth:`Profiler.set_phase`: ``decode`` / ``handler:<TAG>`` /
  ``wal_fsync`` / ``submit_flush`` / ``periodic``; the balancer thread
  publishes ``balancer_tick``) so each sample lands in the tick phase
  it interrupted. Markers are edge-set (a plain per-thread dict write,
  nanoseconds) — a sample between two edges attributes to the previous
  phase, which at 19 Hz vs sub-ms phases is the usual sampling blur.
* **windows** — besides the cumulative counters, samples also land in
  the current **window**: ``window_id = int(t_mono // WINDOW_S)``,
  i.e. windows are aligned to the host's shared CLOCK_MONOTONIC, so a
  window id computed from a journey span's timestamp on ANY co-located
  rank names the same wall interval (the tail↔profile join needs no
  clock exchange). Sealed windows keep their top stacks only, in a
  bounded ring.

Counters are CUMULATIVE and delta-gossiped over ``SS_OBS_SYNC`` like
registry instruments (changed-stacks-only; a lost frame heals on the
next change). The master serves the merged fleet profile at
``/profile`` (collapsed-stack text, or JSON with ``?format=json``);
render offline with ``scripts/obs_report.py --profile``.

One profiler per PROCESS: in-proc worlds run many server threads in one
interpreter, and ``sys._current_frames()`` sees them all — the first
server to start one owns it (and gossips it); later servers share the
instance for phase markers only, so the fleet view counts each process
exactly once.

Overhead: one ``sys._current_frames()`` + a frame walk per tick. At
19 Hz with ~10 threads x ~30 frames that is well under 0.1% of a core
(the ``profile_overhead`` bench row bounds the end-to-end cost at
<= 1.05x pop latency, same bar as the trace arms).
"""

from __future__ import annotations

import sys
import threading
from collections import deque
from time import monotonic as _monotonic
from typing import Optional

# window geometry: 1 s windows, last 64 kept (≈ a minute of history for
# the tail join), top 40 stacks per sealed window
WINDOW_S = 1.0
MAX_WINDOWS = 64
WINDOW_TOP_STACKS = 40

MAX_DEPTH = 48     # frames kept per stack (outermost dropped beyond it)
MAX_STACKS = 4096  # distinct folded keys; beyond it samples fold into
# a per-role "<overflow>" key instead of growing without bound

# thread ident -> declared role; module-global so threads can register
# before (or without) a profiler existing. Never cleared — idents are
# reused by the OS, but a reused ident belongs to a NEW thread that
# re-registers (or falls back to its thread name).
_roles: dict[int, str] = {}

_lock = threading.Lock()
_active: "Optional[Profiler]" = None


def register_thread(role: str, ident: Optional[int] = None) -> None:
    """Declare the calling thread's role for stack folding. Cheap and
    unconditional — call it whether or not profiling is armed."""
    _roles[threading.get_ident() if ident is None else ident] = role


def start(hz: float, rank: int) -> Optional["Profiler"]:
    """Start the per-process profiler and return it iff the caller now
    OWNS it (first starter wins; later callers get None and should use
    :func:`active` for phase markers only — ownership decides who
    gossips, so a shared process is counted once)."""
    global _active
    if hz <= 0:
        return None
    with _lock:
        if _active is not None:
            return None
        p = Profiler(hz, rank)
        _active = p
    p._start_thread()
    return p


def active() -> Optional["Profiler"]:
    return _active


def stop(p: Optional["Profiler"]) -> None:
    """Stop an owned profiler (no-op for None / a non-owner handle)."""
    global _active
    if p is None:
        return
    p._stop_thread()
    with _lock:
        if _active is p:
            _active = None


def window_of(t_mono: float) -> int:
    """The window id covering a CLOCK_MONOTONIC stamp — shared math
    with the journey side of the tail↔profile join."""
    return int(t_mono // WINDOW_S)


class Profiler:
    """One process's folded-stack sampler. Construct via :func:`start`."""

    def __init__(self, hz: float, rank: int) -> None:
        self.hz = float(hz)
        self.rank = rank
        self.samples = 0
        # folded stack -> cumulative sample count (reader: the ops
        # scrape / gossip delta; writes are GIL-atomic dict ops, same
        # discipline as the metrics registry)
        self.counts: dict[str, int] = {}
        # sealed windows, oldest first: {"id", "t0", "t1", "stacks"}
        self.windows: deque = deque(maxlen=MAX_WINDOWS)
        self._win_id = window_of(_monotonic())
        self._win_counts: dict[str, int] = {}
        self._phases: dict[int, str] = {}     # thread ident -> phase
        self._names: dict[int, str] = {}      # ident -> thread-name cache
        self._code_names: dict = {}           # code object -> display name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ident: Optional[int] = None

    # -- lifecycle -----------------------------------------------------------

    def _start_thread(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"adlb-prof-{self.rank}"
        )
        self._thread.start()

    def _stop_thread(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def _run(self) -> None:
        self._ident = threading.get_ident()
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — a torn frame walk must
                pass  # never kill the sampler (threads die mid-walk)

    # -- markers -------------------------------------------------------------

    def set_phase(self, phase: str) -> None:
        """Publish the calling thread's current phase (edge-set)."""
        self._phases[threading.get_ident()] = phase

    # -- sampling ------------------------------------------------------------

    def _frame_name(self, code) -> str:
        name = self._code_names.get(code)
        if name is None:
            fn = code.co_filename
            base = fn[fn.rfind("/") + 1:]
            if base.endswith(".py"):
                base = base[:-3]
            name = self._code_names[code] = f"{base}.{code.co_name}"
        return name

    def _role_of(self, ident: int) -> str:
        role = _roles.get(ident)
        if role is not None:
            return role
        name = self._names.get(ident)
        if name is None:
            for t in threading.enumerate():
                if t.ident is not None and t.ident not in self._names:
                    self._names[t.ident] = t.name
            name = self._names.get(ident, f"tid-{ident}")
        return name

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sampling tick: every live thread's stack (except the
        sampler's own) folds into the cumulative and current-window
        counters. Exposed for deterministic tests."""
        t = _monotonic() if now is None else now
        wid = window_of(t)
        if wid != self._win_id:
            self._seal_window()
            self._win_id = wid
        own = self._ident if self._ident is not None \
            else threading.get_ident()
        counts, win = self.counts, self._win_counts
        for ident, frame in sys._current_frames().items():
            if ident == own:
                continue
            parts = []
            f, depth = frame, 0
            while f is not None and depth < MAX_DEPTH:
                parts.append(self._frame_name(f.f_code))
                f = f.f_back
                depth += 1
            parts.reverse()
            head = [self._role_of(ident)]
            phase = self._phases.get(ident)
            if phase is not None:
                head.append(f"phase:{phase}")
            key = ";".join(head + parts)
            if key not in counts and len(counts) >= MAX_STACKS:
                key = f"{head[0]};<overflow>"
            counts[key] = counts.get(key, 0) + 1
            win[key] = win.get(key, 0) + 1
        self.samples += 1

    def _seal_window(self) -> None:
        if self._win_counts:
            top = dict(sorted(
                self._win_counts.items(), key=lambda kv: -kv[1]
            )[:WINDOW_TOP_STACKS])
            self.windows.append({
                "id": self._win_id,
                "t0": round(self._win_id * WINDOW_S, 3),
                "t1": round((self._win_id + 1) * WINDOW_S, 3),
                "stacks": top,
            })
            self._win_counts = {}

    # -- export --------------------------------------------------------------

    def _stable_counts(self) -> list:
        """Item list of the cumulative counters, retried against the
        sampler thread inserting a first-seen stack mid-copy (the same
        discipline as metrics.safe_copy; value updates are GIL-atomic)."""
        for _ in range(8):
            try:
                return list(self.counts.items())
            except RuntimeError:
                continue
        return []

    def snapshot(self) -> dict:
        """Whole-profile view (the master's own live contribution)."""
        return {
            "hz": self.hz,
            "samples": self.samples,
            "stacks": dict(self._stable_counts()),
            "win": _stable_list(self.windows),
        }

    def take_delta(self, last: dict) -> dict:
        """Changed-stacks-only cumulative delta + windows sealed since
        the previous ship — the SS_OBS_SYNC gossip body. ``last`` is
        the caller-held memo, mutated in place (same contract as
        ``Registry.delta_snapshot``)."""
        ls = last.setdefault("s", {})
        out_stacks = {}
        for k, v in self._stable_counts():
            if ls.get(k) != v:
                ls[k] = out_stacks[k] = v
        last_win = last.get("w", -1)
        wins = [w for w in _stable_list(self.windows) if w["id"] > last_win]
        if wins:
            last["w"] = wins[-1]["id"]
        out: dict = {}
        if out_stacks:
            out["stacks"] = out_stacks
        if wins:
            out["win"] = wins
        if out:
            out["hz"] = self.hz
            out["samples"] = self.samples
        return out


def _stable_list(seq) -> list:
    """Copy a deque the sampler thread may be appending to (appends are
    atomic; iteration during a mutation raises — retry)."""
    for _ in range(8):
        try:
            return list(seq)
        except RuntimeError:
            continue
    return []


def merge_stacks(per_rank: dict) -> dict:
    """Elementwise sum of per-rank ``{stack: count}`` dicts — the
    master's merged fleet view on ``/profile``."""
    merged: dict[str, int] = {}
    for stacks in per_rank.values():
        for k, v in stacks.items():
            merged[k] = merged.get(k, 0) + v
    return merged


def collapsed_text(stacks: dict) -> str:
    """Flamegraph-compatible collapsed form: one ``stack count`` line
    per folded stack, heaviest first."""
    lines = [
        f"{k} {v}"
        for k, v in sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
    ]
    return "\n".join(lines) + ("\n" if lines else "")
