"""The batched global assignment solve.

Inputs are fixed-shape tensors (S servers x K tasks, S x R requesters, T
types); variable-size queue state
is truncated on the host side (highest priorities first) and anything that
does not fit is simply handled next round — staleness is already part of the
protocol contract (plan entries are validated against live state at
enactment, like the reference's push/RFR races, ``src/adlb.c:2182-2192``).

Algorithm (single device): exact sequential greedy — tasks in descending
priority order (stable, so FIFO on ties, matching the reference's
algebraically-largest-``work_prio`` + seqno contract), each taking the first
open compatible requester. On the card the whole solve is one sort and one
launch of the hand-written kernel (:mod:`adlb_tpu_torch.balancer.greedy_sweep`)
behind one pinned copy each way (:class:`CudaHandoff`); on the CPU its plain
PyTorch version runs the same steps. This is exactly the
matching the reference's per-server ``wq_find_hi_prio`` loop would produce if
it could see every server's queue at once (reference ``src/xq.c:190-247``) —
which is the point: same semantics, global scope, O(1) staleness.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

import torch

from adlb_tpu_torch.balancer import greedy_sweep
from adlb_tpu_torch.balancer.jobdim import bias_vector, expand_types

# Sentinel far below any real priority (int32-safe; real priorities are
# clipped to +/-1e9, reference priorities are C ints).
_NEG = -(2**31) + 1
_PRIO_CLIP = 10**9
_I32MAX = 2**31 - 1

#: solves by route across every solver of the process ("device": the
#: kernel or its plain version on the CPU; "host": the numpy twin). An
#: in-process world that loses its master runs two planner threads for up
#: to a second, so the counts and the check tallies change under ``_lock``
solve_counts = {"device": 0, "host": 0}

#: every ``check_every``-th device solve of each solver (its 1st, its
#: 1 + check_every-th, ...) keeps a copy of its inputs and result, and
#: :func:`planner_counts` holds the kept ones against the numpy twin
#: ``_host_greedy``, after the solves, off the planning loop's clock.
#: 0 keeps none. A process world's ranks and a launcher read it from
#: ``ADLB_CHECK_SOLVES`` in their environment.
check_every = int(os.environ.get("ADLB_CHECK_SOLVES") or 0)
_kept: list = []  # (solver, inputs, result)
_checks = {"checked": 0, "wrong": 0}
_lock = threading.Lock()


def reset_counts() -> None:
    """Zero the solve counts and the check tallies, drop the kept solves."""
    with _lock:
        solve_counts.update(device=0, host=0)
        _checks.update(checked=0, wrong=0)
        _kept.clear()


def check_kept() -> None:
    """Hold every kept solve against ``_host_greedy``; the tallies go to
    the process and to the solver that made it. A planning process runs
    it before it reports, since its kept solves end with it."""
    while True:
        with _lock:
            if not _kept:
                return
            solver, arrays, out = _kept.pop()
        wrong = not np.array_equal(out, _host_greedy(*arrays))
        with _lock:
            _checks["checked"] += 1
            _checks["wrong"] += wrong
            solver.solves_checked += 1
            solver.solves_wrong += wrong


def planner_counts() -> dict:
    """This process's solve counts, greedy-sweep kernel launches and kept
    solves checked (``solves_checked``) and found different from the numpy
    twin (``solves_wrong``): what the planning rank or sidecar of a process
    world reports back to its harness (``WorldResult.planner``)."""
    check_kept()
    with _lock:
        return {"device_solves": solve_counts["device"],
                "host_solves": solve_counts["host"],
                "greedy_sweep_launches": greedy_sweep.launches,
                "solves_checked": _checks["checked"],
                "solves_wrong": _checks["wrong"]}


def planner_since(before: dict, metrics) -> dict:
    """What a planning process reports to its harness: :func:`planner_counts`
    since ``before``, plus its planning rounds (``rounds``) and their
    host-clock seconds (``round_s``) from ``metrics``' ``balancer_round_s``
    histogram, which :meth:`PlanEngine.round` fills."""
    after = planner_counts()
    rounds = metrics.histogram("balancer_round_s")
    return {**{k: after[k] - before[k] for k in after},
            "rounds": rounds.n, "round_s": rounds.sum}


def _pack2(primary, secondary):
    """One int64 key per pair of int32 tensors, ordered as (primary,
    secondary): every int32 pair fits."""
    return primary.long() * (1 << 32) + (secondary.long() + (1 << 31))


def _stable_argsort2(primary, secondary):
    """argsort along the last dim by (primary asc, secondary asc, index
    asc) for int32 tensors: one stable sort of a packed int64 key. The
    sharded planner's merge (balancer/distributed.py) uses it."""
    return torch.sort(_pack2(primary, secondary), dim=-1, stable=True).indices


def _stable_argsort3(primary, secondary, tertiary):
    """argsort along the last dim by (primary asc, secondary asc, tertiary
    asc, index asc) for int32 tensors: a stable sort of the packed
    (secondary, tertiary) key, then a stable sort by primary — two sorts
    where the JAX package composes three."""
    o = _stable_argsort2(secondary, tertiary)
    p = torch.sort(primary.gather(-1, o), dim=-1, stable=True).indices
    return o.gather(-1, p)


def check_device(device: str) -> torch.device:
    """The torch device a solver runs on: "cuda" (the default) needs a
    card and raises without one — the port never carries on on the CPU
    unless the caller asked for it with "cpu"."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r} (want 'cuda' or 'cpu')")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the planner's plain torch version")
    return torch.device(device)


def solver_inputs_from_numpy(task_prio, task_type, req_mask, req_valid,
                             device) -> tuple:
    """The four packed numpy arrays of :class:`AssignmentSolver` (int32
    [NT], int32 [NT], bool [NR, T], bool [NR]) as tensors on ``device`` —
    the hand-off that ``jnp.asarray`` is in the JAX package. The solver's
    card route uses :class:`CudaHandoff` instead."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (task_prio, task_type, req_mask, req_valid)
    )


class CudaHandoff:
    """The card's device solve for one (NT, NR, T) shape, with buffers kept
    from solve to solve: a pinned host staging buffer that the four packed
    arrays are copied into, its device twin, the kernel's
    :class:`~adlb_tpu_torch.balancer.greedy_sweep.Workspace`, and a pinned
    host copy of the kernel's output (assign, then the route word). A solve
    is one H2D copy, one sort, one kernel launch, one D2H copy and one wait.
    The copies into the staging buffer (memoryview assignment), the two
    device copies and the launch (the kernel library's, through
    ctypes.PyDLL) keep the interpreter lock, so the balancer thread gives it
    up twice per solve, in the sort and in the wait, instead of once per
    torch op."""

    def __init__(self, nt: int, nr: int, ntypes: int, device) -> None:
        self.work = greedy_sweep.Workspace(nt, nr, ntypes, device)
        self.shape = self.work.shape
        self.device = device
        sizes = (4 * nt, 4 * nt, nr * ntypes, nr)
        offs = [0]
        for n in sizes:
            offs.append(offs[-1] + -(-n // 256) * 256)  # 256-byte aligned
        self.nbytes = offs[-1]
        self.host = torch.empty((max(self.nbytes, 1),), dtype=torch.uint8,
                                pin_memory=True)
        self.dev = torch.empty_like(self.host, device=device)
        self.staging = memoryview(self.host.numpy())
        #: (byte span of the staging buffer, dtype) per packed array
        self.spans = tuple(
            (slice(o, o + n), dt) for o, n, dt in
            zip(offs, sizes, (np.int32, np.int32, np.bool_, np.bool_)))
        self.prio = self.dev[:sizes[0]].view(torch.int32)
        base = self.dev.data_ptr()
        #: device pointers of the task types, masks and validity
        self.inputs = (base + offs[1], base + offs[2], base + offs[3])
        self.host_out = torch.empty((nr + 1,), dtype=torch.int32,
                                    pin_memory=True)
        self.out_np = self.host_out.numpy()
        #: (dst, src, bytes) of the H2D and the D2H copy
        self.h2d = (base, self.host.data_ptr(), self.nbytes)
        self.d2h = (self.host_out.data_ptr(), self.work.out.data_ptr(),
                    4 * (nr + 1))
        #: host-clock seconds of the last solve: (hand-off, sort and launch
        #: enqueue, wait for the result)
        self.split = (0.0, 0.0, 0.0)

    def solve(self, task_prio, task_type, req_mask, req_valid) -> np.ndarray:
        """assign[NR] int32 (numpy) for the packed arrays."""
        t0 = time.perf_counter()
        for (span, dt), a in zip(self.spans,
                                 (task_prio, task_type, req_mask, req_valid)):
            self.staging[span] = memoryview(
                np.ascontiguousarray(a, dtype=dt)).cast("B")
        stream = torch.cuda.current_stream(self.device)
        handle = stream.cuda_stream
        with torch.cuda.device(self.device):  # the copies and launch there
            greedy_sweep.copy_raw(*self.h2d, handle)
            t1 = time.perf_counter()
            self.work.run(self.prio, *self.inputs, handle)
            greedy_sweep.copy_raw(*self.d2h, handle)
        t2 = time.perf_counter()
        stream.synchronize()
        assign = self.out_np[:self.shape[1]].copy()
        self.split = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        return assign


def _host_greedy(task_prio, task_type, req_mask, req_valid):
    """Numpy twin of the device sweep — bit-identical semantics, used
    below a size threshold where an accelerator dispatch round-trip costs
    more than the whole solve.

    Considers only tasks whose type some open requester accepts (tasks of
    other types can never match, so skipping them cannot change the greedy
    outcome) and early-exits once every requester is matched — so a round
    where the only parked requester wants a type with no queued inventory
    (gfmc's answer collector) costs one vectorized mask, not a scan."""
    NR = req_mask.shape[0]
    assign = np.full((NR,), -1, dtype=np.int32)
    open_req = req_valid.copy()
    n_open = int(open_req.sum())
    if n_open == 0:
        return assign
    wanted = req_mask[open_req].any(axis=0)  # [T]
    live = (task_prio > int(_NEG)) & (task_type >= 0)
    live &= wanted[np.clip(task_type, 0, None)]
    cand = np.nonzero(live)[0]
    if cand.size == 0:
        return assign
    order = cand[np.argsort(-task_prio[cand], kind="stable")]
    for t in order:
        tt = task_type[t]
        compat = open_req & req_mask[:, tt]
        r = int(np.argmax(compat))
        if not compat[r]:
            continue
        assign[r] = t
        open_req[r] = False
        n_open -= 1
        if n_open == 0:
            break
    return assign


class AssignmentSolver:
    """Host-side wrapper: packs per-server snapshots into fixed-shape arrays,
    runs the greedy solve, unpacks plan entries.

    Adaptive placement: instances with few live requesters run the numpy twin
    on the host (an accelerator dispatch round-trip would dominate); larger
    instances run the greedy-sweep kernel on the card. Both produce the identical
    matching (same greedy order), so the threshold is purely a latency
    knob.

    ``solve`` also accepts the engine's array-resident host ledger (a
    :class:`adlb_tpu_torch.balancer.ledger.ArrayLedger` view) in place of the
    snapshot dict: the packed kept-requester / eligible-task rows are
    consumed directly — no per-row tuple walk — and the matching is
    identical to the dict path (fuzz-proven by tests/test_ledger_parity)."""

    #: the engine may hand solve() a LedgerView instead of a snapshot dict
    SUPPORTS_VIEW = True

    def __init__(
        self, types: Sequence[int], max_tasks: int, max_requesters: int,
        rounds: int = 6, host_threshold_reqs: Optional[int] = 64,
        backend: str = "auto", max_jobs: int = 1,
        job_weights: Optional[dict] = None, device: str = "cuda",
    ) -> None:
        """backend: "auto" only — the device solve is the greedy-sweep
        kernel on "cuda" and its plain torch version on "cpu"
        (balancer/greedy_sweep.py); both give the matching of the numpy
        twin. device: where the device solve runs; "cuda" without a card
        raises here."""
        if backend != "auto":
            raise ValueError(f"unknown solver backend {backend!r}")
        self.device = check_device(device)
        self.base_types = tuple(types)
        self.base_T = max(len(self.base_types), 1)
        self.max_jobs = max(int(max_jobs), 1)
        # composite (job, type) axis under multi-job planning — the
        # base types verbatim when single-job (balancer/jobdim.py)
        self.types = expand_types(self.base_types, self.max_jobs)
        self.job_bias = bias_vector(job_weights, self.max_jobs)
        self.type_index = {t: i for i, t in enumerate(self.types)}
        self.K = max_tasks
        self.R = max_requesters
        self.rounds = rounds
        self.host_threshold_reqs = host_threshold_reqs
        self.backend = backend
        self.solve_count = 0
        self.host_solve_count = 0
        #: this solver's device solves, their (tasks, requesters) shapes,
        #: and its kept ones found equal (``solves_checked``) or not
        #: (``solves_wrong``) to the numpy twin by :func:`check_kept`
        self.device_solve_count = 0
        self.device_shapes: set = set()
        self.solves_kept = self.solves_checked = self.solves_wrong = 0
        #: the card route's buffers, made at the first device solve and
        #: again when the packed shape changes
        self.handoff: Optional[CudaHandoff] = None
        self._retired_launches = 0  # of the handoffs replaced so far

    def set_job_bias(self, job_weights: Optional[dict]) -> bool:
        """Install new fair-share biases for the dict-path packers (the
        view path inherits the ledger's — the engine keeps both in
        step). Returns True when the bias changed."""
        bias = bias_vector(job_weights, self.max_jobs)
        if bias == self.job_bias:
            return False
        self.job_bias = bias
        return True

    def planner_counts(self) -> dict:
        """This solver's own counts, in :func:`planner_counts`' keys plus
        ``solves_kept`` and ``device_shapes`` (the sorted [tasks,
        requesters] shapes it solved at): what one planner did, where the
        process-wide counts sum every planner of the process. The check
        tallies are those of the :func:`check_kept` calls made so far."""
        with _lock:
            return {"device_solves": self.device_solve_count,
                    "host_solves": self.host_solve_count,
                    "greedy_sweep_launches": self.kernel_launches,
                    "solves_kept": self.solves_kept,
                    "solves_checked": self.solves_checked,
                    "solves_wrong": self.solves_wrong,
                    "device_shapes": sorted(
                        list(s) for s in self.device_shapes)}

    @property
    def kernel_launches(self) -> int:
        """Greedy-sweep kernel launches of this solver's device solves."""
        return self._retired_launches + (
            self.handoff.work.launches if self.handoff is not None else 0)

    def _device_solve(self, task_prio, task_type, req_mask, req_valid):
        with _lock:
            solve_counts["device"] += 1
            self.device_solve_count += 1
            self.device_shapes.add((task_prio.shape[0], req_mask.shape[0]))
            keep = (check_every
                    and (self.device_solve_count - 1) % check_every == 0)
        arrays = (task_prio, task_type, req_mask, req_valid)
        if self.device.type == "cuda":
            shape = (task_prio.shape[0],) + req_mask.shape
            if self.handoff is None or self.handoff.shape != shape:
                self._retired_launches = self.kernel_launches
                self.handoff = CudaHandoff(*shape, self.device)
            out = self.handoff.solve(*arrays)
        else:
            inputs = solver_inputs_from_numpy(*arrays, self.device)
            out = greedy_sweep.greedy_assign_torch(*inputs).numpy()
        if keep:
            with _lock:
                self.solves_kept += 1
                _kept.append((self, [np.array(a) for a in arrays],
                              out.copy()))
        return out

    def solve(self, snapshots, world) -> list:
        """snapshots: server_rank -> {"tasks": [(seqno, type, prio, len)...],
        "reqs": [(rank, rqseqno, req_types|None)...]} — or an
        ArrayLedger view (see class docstring).

        Returns [(holder_server, seqno, req_home_server, for_rank, rqseqno)].
        """
        if getattr(snapshots, "is_array", False):
            return self._solve_view(snapshots)
        servers = sorted(snapshots)
        S, K, R, T = len(servers), self.K, self.R, len(self.types)
        if S == 0:
            return []
        req_mask = np.zeros((S * R, T), dtype=bool)
        req_valid = np.zeros((S * R,), dtype=bool)
        req_ref: list = [None] * (S * R)
        J, T0 = self.max_jobs, self.base_T
        for si, s in enumerate(servers):
            # req tuples are (rank, rqseqno, types) — a 4th element
            # (fused-reserve flag, consumed by the plan-match sender)
            # may ride along since the remote-fused-fetch change, and a
            # 5th (job) since multi-job planning. Job handling is the
            # exact twin of ledger._rebuild_reqs: any-type becomes a
            # job-block mask, overflow jobs pack an empty mask.
            for ri, req in enumerate(snapshots[s]["reqs"][:R]):
                rank, rqseqno, req_types = req[0], req[1], req[2]
                jb = (req[4] if len(req) > 4 else 0) if J > 1 else 0
                i = si * R + ri
                req_valid[i] = True
                if J > 1 and not 0 <= jb < J:
                    pass  # overflow job: planner-invisible
                elif req_types is None:
                    if J <= 1:
                        req_mask[i, :] = True
                    else:
                        req_mask[i, jb * T0:(jb + 1) * T0] = True
                else:
                    for t in req_types:
                        ti = self.type_index.get(t if J <= 1 else (jb, t))
                        if ti is not None:
                            req_mask[i, ti] = True
                req_ref[i] = (s, rank, rqseqno)
        n_reqs = int(req_valid.sum())
        if n_reqs == 0:
            return []

        host = (
            self.host_threshold_reqs is not None
            and n_reqs <= self.host_threshold_reqs
        )
        if host:
            # pack only tasks of a type some requester wants: others can
            # never match, and skipping them up front keeps the per-round
            # host cost proportional to useful work, not queue depth
            wanted = req_mask[req_valid].any(axis=0)  # [T]
            prios: list = []
            ttypes: list = []
            task_ref = []
            bias, nb = self.job_bias, len(self.job_bias)
            for si, s in enumerate(servers):
                for tk in snapshots[s]["tasks"][:K]:
                    seqno, wtype, prio = tk[0], tk[1], tk[2]
                    jb = (tk[4] if len(tk) > 4 else 0) if J > 1 else 0
                    ti = self.type_index.get(
                        wtype if J <= 1 else (jb, wtype), -1)
                    if ti < 0 or not wanted[ti]:
                        continue
                    b = bias[jb] if 0 <= jb < nb else 0
                    prios.append(
                        max(-_PRIO_CLIP, min(_PRIO_CLIP, prio)) + b)
                    ttypes.append(ti)
                    task_ref.append((s, seqno))
            if not task_ref:
                return []
            task_prio = np.asarray(prios, dtype=np.int32)
            task_type = np.asarray(ttypes, dtype=np.int32)
            assign = _host_greedy(task_prio, task_type, req_mask, req_valid)
            with _lock:
                self.host_solve_count += 1
                solve_counts["host"] += 1
        else:
            task_prio = np.full((S * K,), int(_NEG), dtype=np.int32)
            task_type = np.full((S * K,), -1, dtype=np.int32)
            task_ref = [None] * (S * K)
            bias, nb = self.job_bias, len(self.job_bias)
            for si, s in enumerate(servers):
                for ki, tk in enumerate(snapshots[s]["tasks"][:K]):
                    seqno, wtype, prio = tk[0], tk[1], tk[2]
                    jb = (tk[4] if len(tk) > 4 else 0) if J > 1 else 0
                    i = si * K + ki
                    b = bias[jb] if 0 <= jb < nb else 0
                    task_prio[i] = \
                        max(-_PRIO_CLIP, min(_PRIO_CLIP, prio)) + b
                    task_type[i] = self.type_index.get(
                        wtype if J <= 1 else (jb, wtype), -1)
                    task_ref[i] = (s, seqno)
            if (task_type < 0).all():
                return []
            assign = self._device_solve(
                task_prio, task_type, req_mask, req_valid)
        self.solve_count += 1

        pairs = []
        for i, t in enumerate(assign):
            if t < 0 or req_ref[i] is None or task_ref[t] is None:
                continue
            holder, seqno = task_ref[t]
            req_home, for_rank, rqseqno = req_ref[i]
            pairs.append((holder, seqno, req_home, for_rank, rqseqno))
        return pairs

    def _solve_view(self, view) -> list:
        """The array-ledger fast path: identical greedy matching over the
        ledger's packed per-server rows (kept requesters truncated [:R],
        eligible tasks [:K], sorted-server row order — exactly the dict
        packer's layout), with no per-row Python walk."""
        K, R, T = self.K, self.R, len(self.types)
        # the ledger is built from the same engine Config; the row
        # layouts must agree or refs would misindex
        assert (view.K, view.R, tuple(view.types)) == (K, R, self.types)
        slots = view.slot_order
        S = slots.size
        if S == 0:
            return []
        req_valid = view.pk_rv[slots].reshape(-1)
        n_reqs = int(req_valid.sum())
        if n_reqs == 0:
            return []
        req_mask = view.pk_rm[slots].reshape(S * R, T)
        task_prio = view.pk_tp[slots].reshape(-1)
        task_type = view.pk_tt[slots].reshape(-1)
        host = (
            self.host_threshold_reqs is not None
            and n_reqs <= self.host_threshold_reqs
        )
        if host:
            # _host_greedy's internal wanted/live filter makes the
            # compacted pre-pack of the dict path unnecessary: same
            # candidates, same stable order, same matching
            assign = _host_greedy(task_prio, task_type, req_mask, req_valid)
            with _lock:
                self.host_solve_count += 1
                solve_counts["host"] += 1
            if not (assign >= 0).any():
                return []
        else:
            if (task_type < 0).all():
                return []
            assign = self._device_solve(
                task_prio, task_type, req_mask, req_valid)
        self.solve_count += 1
        pairs = []
        slot_list = slots.tolist()
        trefs, rrefs = view.pk_trefs, view.pk_rrefs
        for i in np.flatnonzero(assign >= 0).tolist():
            t = int(assign[i])
            tref = trefs[slot_list[t // K]][t % K]
            rref = rrefs[slot_list[i // R]][i % R]
            if tref is None or rref is None:
                continue
            holder, seqno = tref
            req_home, for_rank, rqseqno = rref
            pairs.append((holder, seqno, req_home, for_rank, rqseqno))
        return pairs
