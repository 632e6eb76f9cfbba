"""The job dimension of the planning tiers (multi-job balancing).

The tpu balancer historically planned job 0 only: non-default
namespaces were kept out of balancer snapshots and fell back to the
qmstat RFR pull. Multi-job planning lifts that by giving every
snapshot row an optional JOB COLUMN and folding it into a COMPOSITE
TYPE INDEX::

    ci = job * T + base_type_index        (T = len(world.types))

so every matching kernel — the jitted greedy scan, the Pallas sweep,
the sharded candidate-gen/merge/auction program — stays completely
untouched: they see ``T' = max_jobs * T`` generic types and the job
isolation (a unit only ever matches requesters of its own namespace)
is structural, carried by the mask/type columns the packers build.
Only the packers change, and all of them (ledger twins, the
single-device dict path, the sharded tuple path) change through the
helpers below, so the pair-list-identity contract between the tiers
is preserved by construction (tests/test_ledger_parity.py and
tests/test_device_auction.py fuzz the job arm).

Wire shape: tasks grow a 5th element ``(seqno, type, prio, len, job)``
and reqs a 5th ``(rank, rqseqno, types, fetch, job)`` ONLY when the
job is non-default — single-job worlds stay byte-identical on every
frame. ``max_jobs <= 1`` (the default) reproduces the historical
planner exactly: same shapes, same compiled programs, same pairs.

Weights: per-job shares enter the assignment score as an int32-safe
PRIORITY BIAS folded into the clipped-prio columns at pack time::

    eff_prio = clip(prio, +/-1e9) + bias(job)
    bias(w)  = round((w - 1.0) * 1e6), clipped to +/-1e9

Weight 1.0 (the default) is bias 0 — frame and pair identity for
unweighted worlds. The bias headroom fits int32 (2e9 < 2^31-1) and
stays strictly above the _NEG padding sentinel. A weight of 1.001
outranks ~1000 native priority levels; weights are SHARES, priorities
stay the intra-job ordering.

Job ids are small sequential ints allocated by the master (0 = the
default namespace), so job -> slot is the identity while ``job <
max_jobs``. Overflow jobs (id >= max_jobs) stay invisible to the
planner — their tasks pack as the unknown-type sentinel (-1, never
matched) and their cross-server path remains the per-job qmstat RFR
fallback the steal mode uses.
"""

from __future__ import annotations

from typing import Optional, Sequence

#: clip shared with the solvers' priority clip: |bias| <= 1e9 keeps
#: eff_prio inside int32 with the +/-1e9 prio clip already applied
_BIAS_CLIP = 10**9

#: one weight point = this many priority levels
_BIAS_SCALE = 1_000_000


def weight_bias(weight: float) -> int:
    """Int32-safe priority bias for one job weight (1.0 -> 0)."""
    b = int(round((float(weight) - 1.0) * _BIAS_SCALE))
    return max(-_BIAS_CLIP, min(_BIAS_CLIP, b))


def bias_vector(job_weights: Optional[dict], max_jobs: int) -> tuple:
    """Per-slot bias tuple (length ``max(max_jobs, 1)``) from a
    ``{job_id: weight}`` map; jobs beyond ``max_jobs`` are ignored
    (the planner cannot see them)."""
    n = max(max_jobs, 1)
    bias = [0] * n
    for j, w in (job_weights or {}).items():
        j = int(j)
        if 0 <= j < n:
            bias[j] = weight_bias(w)
    return tuple(bias)


def expand_types(types: Sequence, max_jobs: int) -> tuple:
    """The composite type tuple the solvers/ledgers are shaped by:
    the base types themselves for single-job planning (exact
    back-compat, including type-value semantics for off-world types),
    else ``(job, base_type)`` pairs in job-major order — so composite
    index = job * T + base index, and type-value lookups stay one
    dict probe via :func:`type_key`."""
    if max_jobs <= 1:
        return tuple(types)
    return tuple((j, t) for j in range(max_jobs) for t in types)


def type_key(job: int, wtype, max_jobs: int):
    """The composite type-index key for one (job, raw type) pair —
    the raw type itself under single-job planning."""
    return wtype if max_jobs <= 1 else (job, wtype)


def task_job(t) -> int:
    """Job column of a snapshot task tuple (0 when absent)."""
    return t[4] if len(t) > 4 else 0


def req_job(r) -> int:
    """Job column of a snapshot req tuple (0 when absent)."""
    return r[4] if len(r) > 4 else 0
