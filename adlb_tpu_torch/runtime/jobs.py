"""Job namespaces: multi-tenancy over one persistent server fleet.

The reference binds one world to one job to one process lifetime — the
pool has no namespace column, termination is world-global, and the only
way to run a second workload is a second fleet. Service mode multiplexes
*jobs* over the same servers:

* every wire frame may carry a ``job_id`` (codec field 97; omitted = the
  default namespace 0, so single-job worlds stay byte-identical on the
  wire);
* the work queue partitions per job (:class:`PartitionedWorkQueue`) and
  a requester only ever matches units of its own namespace;
* termination is per job: the master runs the two-pass exhaustion ring
  *per job* (token stamped with the job id), and a completed job's
  parked requesters are flushed with ``ADLB_DONE_BY_EXHAUSTION`` without
  touching any other job — one job draining never blocks another;
* admission is per tenant: a job's ``quota_bytes`` bounds its queued
  bytes per server, enforced at put with ``ADLB_BACKOFF`` +
  ``retry_after_ms`` (the memory backpressure mechanism made per-job);
* the control plane is the ops endpoint's ``/jobs`` surface (submit /
  status / drain / kill) plus the in-band ``FA_JOB_CTL`` round trip that
  ``ctx.submit_job()`` / ``ctx.attach()`` use.

Lifecycle: RUNNING -> (drain) DRAINING -> DONE, or -> (kill) KILLED.
Draining rejects new puts (``ADLB_NO_MORE_WORK``) while queued work
completes; kill drops the job's partition outright and flushes its
parked requesters. State changes fan out as ``SS_JOB_CTL`` and ride the
replication stream / WAL as ``OP_JOB`` entries, so job lifecycle
survives failover and cold restart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

RUNNING = "running"
DRAINING = "draining"
DONE = "done"
KILLED = "killed"

# wire/WAL state codes (replica.OP_JOB)
STATE_CODES = {RUNNING: 0, DRAINING: 1, DONE: 2, KILLED: 3}
CODE_STATES = {v: k for k, v in STATE_CODES.items()}

# job ids are small positive ints allocated by the master; 0 is the
# default/legacy namespace every world has implicitly
DEFAULT_JOB = 0


@dataclasses.dataclass
class Job:
    """One namespace's per-server view."""

    job_id: int
    name: str = ""
    state: str = RUNNING
    # per-server cap on this job's queued bytes (0 = unlimited): the
    # per-tenant admission quota — a put that would cross it answers
    # ADLB_BACKOFF with a retry-after hint, exactly the overload
    # backpressure discipline, scoped to the tenant
    quota_bytes: int = 0
    # fair-share weight (1.0 = neutral): folded into the balancer's
    # assignment score as a priority bias (balancer/jobdim.py) so a
    # heavy tenant cannot starve a light one. Fans out on SS_JOB_CTL;
    # deliberately NOT WAL-persisted (OP_JOB's fixed header predates
    # it) — a restarted fleet comes back neutral and the controller /
    # Config(job_weights) re-arms it.
    weight: float = 1.0
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    done_at: Optional[float] = None
    # per-job activity (puts admitted + reservations matched), the
    # per-job analogue of Server.activity the exhaustion double-pass
    # compares across its two rings
    activity: int = 0
    # per-job exhaustion-ring state (master only)
    exhaust_held_since: Optional[float] = None
    exhaust_inflight: bool = False
    exhaust_sent_at: float = 0.0
    exhaust_token_id: int = 0
    # counters (per-server; the ops /jobs view reports the master's)
    puts: int = 0
    quarantined: int = 0
    backoffs: int = 0

    @property
    def accepts_puts(self) -> bool:
        return self.state == RUNNING

    @property
    def closed(self) -> bool:
        return self.state in (DONE, KILLED)

    def summary(self) -> dict:
        return {
            "job_id": self.job_id,
            "name": self.name,
            "state": self.state,
            "quota_bytes": self.quota_bytes,
            "weight": self.weight,
            "submitted_at": self.submitted_at,
            "done_at": self.done_at,
            "puts": self.puts,
            "quarantined": self.quarantined,
            "backoffs": self.backoffs,
        }


class JobTable:
    """job_id -> :class:`Job`, one per server. Lazily creating an entry
    on first sight of an unknown id absorbs the race between a client's
    first frame and the master's SS_JOB_CTL fan-out landing here."""

    def __init__(self) -> None:
        self._jobs: dict[int, Job] = {}

    def get(self, job_id: int) -> Optional[Job]:
        return self._jobs.get(job_id)

    def ensure(self, job_id: int, name: str = "",
               quota_bytes: int = 0) -> Job:
        job = self._jobs.get(job_id)
        if job is None:
            job = self._jobs[job_id] = Job(
                job_id=job_id, name=name, quota_bytes=quota_bytes
            )
        return job

    def apply(self, op: str, job_id: int, name: str = "",
              quota_bytes: int = 0,
              weight: Optional[float] = None) -> Job:
        """One SS_JOB_CTL/OP_JOB state transition; idempotent."""
        job = self.ensure(job_id, name=name, quota_bytes=quota_bytes)
        if weight is not None:
            job.weight = float(weight)
        if op == "submit":
            # re-announce of a live job refreshes quota/name only
            job.name = name or job.name
            if quota_bytes:
                job.quota_bytes = quota_bytes
        elif op == "update":
            # live policy tweak (POST /jobs/<id> or the controller):
            # weight handled above; quota 0 means "leave unchanged"
            # here (use kill/drain to end a tenant, not quota 0) —
            # the controller clears a throttle by restoring the
            # remembered pre-throttle quota, which is never 0 unless
            # it was unlimited, in which case -1 encodes "unlimited"
            if quota_bytes == -1:
                job.quota_bytes = 0
            elif quota_bytes:
                job.quota_bytes = quota_bytes
        elif op == "drain":
            if not job.closed:
                job.state = DRAINING
        elif op == "done":
            if job.state != KILLED:
                job.state = DONE
                job.done_at = time.monotonic()
        elif op == "kill":
            job.state = KILLED
            job.done_at = time.monotonic()
        else:
            raise ValueError(f"unknown job ctl op {op!r}")
        return job

    def restore(self, job_id: int, state_code: int, quota_bytes: int,
                name: str) -> Job:
        """WAL/replica replay: install the logged state directly."""
        job = self.ensure(job_id, name=name, quota_bytes=quota_bytes)
        job.state = CODE_STATES.get(state_code, RUNNING)
        job.name = name or job.name
        job.quota_bytes = quota_bytes
        return job

    def active_ids(self) -> list[int]:
        """Jobs whose termination the master still owes a verdict."""
        return [
            j.job_id for j in self._jobs.values()
            if j.job_id != DEFAULT_JOB and not j.closed
        ]

    def max_id(self) -> int:
        """Highest job id this table has ever seen — the id allocator
        must stay above it across WAL recovery / takeover replay, or a
        post-restart submit would reuse (and inherit the state of) a
        prior tenant's namespace."""
        return max(self._jobs, default=0)

    def weights(self) -> dict[int, float]:
        """Non-neutral fair-share weights, {job_id: weight} — the
        balancer's bias input (balancer/jobdim.bias_vector)."""
        return {
            j.job_id: j.weight for j in self._jobs.values()
            if j.weight != 1.0
        }

    def any_jobs(self) -> bool:
        """True once any non-default namespace exists — the switch that
        turns WORLD-level exhaustion off (service mode: the fleet idles
        between jobs instead of declaring the world done)."""
        return any(j != DEFAULT_JOB for j in self._jobs)

    def values(self) -> list[Job]:
        return list(self._jobs.values())

    def __len__(self) -> int:
        return len(self._jobs)

    def __contains__(self, job_id: int) -> bool:
        return job_id in self._jobs
