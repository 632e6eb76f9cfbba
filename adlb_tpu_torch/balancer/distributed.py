"""The sharded planner: the assignment solve over a task table cut into
shards, the JAX package's ``balancer/distributed.py`` on one card.

The task table — the big axis, servers x queue depth — is device-resident,
cut by server into ``nshards`` logical shards of ``servers_per_shard`` rows
each (the JAX package shards it over a device mesh; here the shards are a
batch dimension on one device), and updated *incrementally* from
per-server snapshot deltas (only changed rows ship; unchanged servers are
skipped by a stamp fast path). Each planning round is three fixed-shape
steps:

1. **sharded candidate generation** — every shard presorts its task block
   by (type, priority desc, gid) and slices each type's top-D candidates,
   D = C + m + 1 (:func:`_shard_candidates`, all shards in one batch).
2. **cross-shard merge** of the [nshards, T, D] per-shard candidates into
   global per-type lists ordered by (prio desc, gid asc): one stable sort of
   a packed key (the JAX package composes two; the order is the same). The
   elastic slot map decouples row order from rank order, so gid order is
   part of the key.
3. **auction rounds** — pure head-pointer logic over the merged per-type
   candidate lists and the [T, C] requester-slot tables (O(plan size)):
   rank-k candidate pairs with the k-th open accepting requester,
   cross-type conflicts resolve by (prio, -gid), a global threshold
   defers any winner that a displaced higher-priority task could cascade
   into, and prefix commits keep every shard's consumed tasks a prefix
   of its sorted type segment (which is what makes step 1's head slices
   exact).

The solver runs one of two tiers over those steps:

- ``auction="device"`` (default): all three steps run on the solver's
  device, the auction as ONE launch of the hand-written CUDA kernel
  ``csrc/auction.cu`` (:mod:`adlb_tpu_torch.balancer.auction`; its plain
  torch version on ``device="cpu"``) over host-compacted requester ids
  (U = T*C distinct ids at most, so the per-round scatters never touch
  O(requesters) state). A planning round is candidates, one sort, one
  kernel launch and one [T, C+1] commit-table readback — no per-round host
  merge, no O(S) host work.
- ``auction="host"``: the retained twin — steps 2-3 on the planner host
  (numpy), with the merged candidate lists cached and patched in place
  between device sweeps. The twin is what the device tier is fuzz-checked
  against (exact same commits from the same state).

Task ids are **rank-keyed**: gid = rank * K + ki (``row_rank`` maps the
resident row to its server rank; int32 on device, so rank * K must stay
under 2**31 — enforced at registration). Because the greedy tie-break is
the gid order itself, slot assignment is free-listed: an elastic join or
leave patches exactly one row and never remaps the world — no full
re-sweep on churn.

The auction reproduces the exact sequential greedy matching of
:func:`adlb_tpu_torch.balancer.solve._host_greedy` — same matched
requester set, same committed task multiset, same total score
(``tests/test_torch_distributed.py`` at 1, 2 and 8 shards) — truncation
aside: at most ``C`` requesters per type are visible per round and ``m``
commits per type can land per auction round, and leftovers are re-planned
by the next balancer tick (the protocol's standing staleness contract: plan
entries are hints validated at enactment).

This replaces the reference's qmstat ring gossip (reference
``src/adlb.c:806-822,1705-1757``): instead of an O(0.1 s) staleness
window on an approximate load vector, the whole queue state is solved
every round.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

import torch

from adlb_tpu_torch.balancer import auction as _auction
from adlb_tpu_torch.balancer.jobdim import bias_vector, expand_types
from adlb_tpu_torch.balancer.solve import (
    _I32MAX, _NEG, _PRIO_CLIP, _stable_argsort2, _stable_argsort3,
    check_device)


def _shard_candidates(tp, tt, rk, T: int, D: int):
    """Candidate generation of every shard at once: presort each shard's
    [Sl, K] task block by (type, prio desc, gid) and slice each type's
    top-D window. gid = rank * K + ki — rank-keyed, NOT row-keyed, so the
    candidate identity (and hence the greedy tie-break) survives elastic
    slot reuse.

    tp, tt: [nshards, Sl, K] int32; rk: [nshards, Sl] int32. Returns
    (cand_prio, cand_gid) [nshards, T, D] int32."""
    ns, Sl, K = tp.shape
    Kl = Sl * K
    dev = tp.device
    tp, tt = tp.reshape(ns, Kl), tt.reshape(ns, Kl)
    gids = (rk.reshape(ns, Sl, 1).to(torch.int32) * K
            + torch.arange(K, dtype=torch.int32, device=dev)).reshape(ns, Kl)
    live = (tp > _NEG) & (tt >= 0)
    prio = torch.clamp(tp, -_PRIO_CLIP, _PRIO_CLIP)
    sort_t = torch.where(live, tt, T)
    order = _stable_argsort3(sort_t, -prio, gids)
    s_prio = prio.gather(1, order)
    s_gid = gids.gather(1, order)
    # per-type segment sizes; types past T cannot start a segment below T
    scount = torch.zeros((ns, T + 1), dtype=torch.int32, device=dev)
    scount.scatter_add_(1, sort_t.clamp(max=T).long(),
                        torch.ones_like(sort_t))
    seg_off = torch.cat(
        [torch.zeros((ns, 1), dtype=torch.int32, device=dev),
         torch.cumsum(scount[:, :T], dim=1, dtype=torch.int32)], dim=1)
    idx = seg_off[:, :T, None] + torch.arange(D, dtype=torch.int32,
                                              device=dev)
    ok = idx < seg_off[:, 1:, None]
    idc = torch.clamp(idx, 0, Kl - 1).reshape(ns, T * D).long()
    cp = torch.where(ok, s_prio.gather(1, idc).view(ns, T, D), _NEG)
    cg = torch.where(ok, s_gid.gather(1, idc).view(ns, T, D), _I32MAX)
    return cp, cg


def _merge_candidates(cp, cg):
    """The device tier's cross-shard merge: [nshards, T, D] per-shard
    candidates into global (prio desc, gid asc) lists [T, nshards*D] — the
    order of :func:`_merge_shard_major`'s two stable sorts, from one sort."""
    T = cp.shape[1]
    ap = cp.permute(1, 0, 2).reshape(T, -1)
    ag = cg.permute(1, 0, 2).reshape(T, -1)
    o = _stable_argsort2(-ap, ag)
    return ap.gather(1, o), ag.gather(1, o)


def _reqwin(req_mask, req_valid, T: int, C: int, perm=None):
    """Requester slot tables: ``reqwin [T, C]`` — the first C valid
    requester row ids accepting each type, in scan order (the greedy
    "first open compatible requester" order) — plus per-type lengths.

    ``perm`` (a full row permutation) sets the scan order; the stateful
    solver passes its rank-sorted row order so the windows match the
    single-device packer's sorted-rank rows exactly even though the
    elastic slot map free-lists physical rows. The WINDOW ENTRIES stay
    physical row ids (extraction indexes the resident refs).

    Chunked early-exit scan: with deep requester tables (1M parked)
    the window is filled from the first few thousand rows, so the
    common-case cost is O(chunk * T), not O(NR * T)."""
    NR = req_valid.shape[0]
    reqwin = np.full((T, C), -1, dtype=np.int32)
    lens = np.zeros((T,), dtype=np.int32)
    CHUNK = 16384
    for a in range(0, NR, CHUNK):
        b = min(a + CHUNK, NR)
        if perm is None:
            vm = req_mask[a:b] & req_valid[a:b, None]  # [chunk, T]
        else:
            rows = perm[a:b]
            vm = req_mask[rows] & req_valid[rows][:, None]
        done = True
        for t in range(T):
            n = int(lens[t])
            if n >= C:
                continue
            idx = np.flatnonzero(vm[:, t])[: C - n]
            if idx.size:
                reqwin[t, n: n + idx.size] = (
                    idx + a if perm is None else rows[idx])
                lens[t] = n + idx.size
            if lens[t] < C:
                done = False
        if done:
            break
    return reqwin, lens


def _host_auction(gp, gg, reqwin, lens, req_open, rounds: int, m: int):
    """The auction rounds (numpy, O(plan size) per round).

    gp/gg: [T, L] merged candidate (prio, gid) lists, prio desc / gid
    asc, _NEG-padded. reqwin/lens: slot tables from :func:`_reqwin`.
    req_open: bool over requester rows, mutated in place. Returns
    ``assigned [T, C]`` of committed gids (-1 = none).

    Exits early the first round that commits nothing: the globally best
    candidate with an open accepting slot always commits (it wins any
    conflict and tops any threshold), so a zero-commit round proves the
    matching is maximal."""
    T, L = gp.shape
    C = reqwin.shape[1]
    head = np.zeros((T,), dtype=np.int64)
    nlive = (gp > _NEG).sum(axis=1)
    slot_valid = np.arange(C)[None, :] < lens[:, None]
    assigned = np.full((T, C), -1, dtype=np.int64)
    arange_m1 = np.arange(m + 1)
    trange = np.arange(T)
    for _ in range(rounds):
        # next m+1 untaken candidates per type (head slice)
        cidx = head[:, None] + arange_m1[None, :]
        okc = cidx < nlive[:, None]
        cl = np.minimum(cidx, L - 1)
        mp_full = np.where(okc, gp[trange[:, None], cl], int(_NEG))
        mg_full = np.where(okc, gg[trange[:, None], cl], _I32MAX)
        mp, mg = mp_full[:, :m], mg_full[:, :m]
        trunc_p, trunc_g = mp_full[:, m], mg_full[:, m]
        # first m open slots per type
        open_ = slot_valid & req_open[np.clip(reqwin, 0, None)]
        sr = np.cumsum(open_, axis=1)
        nopen = sr[:, -1] if C else np.zeros((T,), np.int64)
        # pair_slot[t, j] = index of the (j+1)-th open slot (C = none)
        pair_slot = np.full((T, m), C, dtype=np.int64)
        for t in range(T):
            if nopen[t]:
                k = int(min(nopen[t], m))
                pair_slot[t, :k] = np.flatnonzero(open_[t])[:k]
        valid = (mp > int(_NEG)) & (pair_slot < C)
        rid = np.where(
            valid, reqwin[trange[:, None], np.clip(pair_slot, 0, C - 1)],
            -1)
        # cross-type conflicts: winner per requester by (prio, -gid)
        win = np.zeros((T, m), dtype=bool)
        best: dict = {}
        vt, vj = np.nonzero(valid)
        for t, j in zip(vt.tolist(), vj.tolist()):
            key = (int(mp[t, j]), -int(mg[t, j]))
            r = int(rid[t, j])
            if r not in best or key > best[r][0]:
                best[r] = (key, t, j)
        for r, (_k, t, j) in best.items():
            win[t, j] = True
        win &= valid
        lose = valid & ~win
        # global commit threshold: the best key among losers and each
        # type's truncation sentinel (only while it has an open slot)
        L_key = (int(_NEG), -_I32MAX)
        lt, lj = np.nonzero(lose)
        for t, j in zip(lt.tolist(), lj.tolist()):
            k = (int(mp[t, j]), -int(mg[t, j]))
            if k > L_key:
                L_key = k
        for t in range(T):
            if nopen[t] and trunc_p[t] > int(_NEG):
                k = (int(trunc_p[t]), -int(trunc_g[t]))
                if k > L_key:
                    L_key = k
        # prefix commit above the threshold
        ncommit = 0
        for t in range(T):
            for j in range(m):
                if lose[t, j]:
                    break  # a loss blocks every later rank this round
                if not win[t, j]:
                    continue
                if (int(mp[t, j]), -int(mg[t, j])) <= L_key:
                    continue
                c = int(pair_slot[t, j])
                assigned[t, c] = mg[t, j]
                req_open[rid[t, j]] = False
                head[t] += 1
                ncommit += 1
        if ncommit == 0:
            break
    return assigned


def _compact_reqwin(reqwin):
    """The device tier's requester tables from ``reqwin [T, C]``: the row
    ids compacted to a dense [0, U) id space (U = T*C static; U itself is
    the dump id and marks an empty slot), so the auction's winner/open
    scatters are a few KB, independent of the requester-table depth.
    Returns (rwc [T, C] int32, open0 [U + 1] bool: True for every real
    compacted id)."""
    T, C = reqwin.shape
    U = T * C
    flat = reqwin.reshape(-1)
    pos = np.flatnonzero(flat >= 0)
    uniq, inv = np.unique(flat[pos], return_inverse=True)
    rwc = np.full((U,), U, dtype=np.int32)
    rwc[pos] = inv.astype(np.int32)
    open0 = np.zeros((U + 1,), dtype=bool)
    open0[: uniq.size] = True
    return rwc.reshape(T, C), open0


def _slot_sizes(slots_per_type: Optional[int], cand_width: int,
                rounds: int, NR: int) -> tuple[int, int]:
    """(C, D): requester slots per type and the candidate depth the
    sweep must gather. D = C + m + 1 is load-bearing for exactness —
    heads advance at most C and the threshold sentinel reads m past the
    head — so both solvers size through this one helper."""
    C = min(slots_per_type or max(64, cand_width * max(rounds, 1)), NR)
    C = C or 1
    return C, C + cand_width + 1


def _merge_shard_major(cp, cg):
    """Merge [ndev, T, D] per-shard candidate tables into exact global
    (prio desc, gid asc) lists [T, ndev*D]: two composed stable
    single-key sorts — gid first, then prio desc. (Rank-keyed gids are
    NOT monotone across the shard-major concatenation once the elastic
    slot map reuses rows, so gid order must be restored explicitly
    before the priority sort; padding gids are _I32MAX and sort last
    within the _NEG-priority run, as before.)"""
    T = cp.shape[1]
    ap = cp.transpose(1, 0, 2).reshape(T, -1)
    ag = cg.transpose(1, 0, 2).reshape(T, -1)
    o = np.argsort(ag, axis=1, kind="stable")
    ap = np.take_along_axis(ap, o, axis=1)
    ag = np.take_along_axis(ag, o, axis=1)
    mi = np.argsort(-ap, axis=1, kind="stable")
    return (
        np.take_along_axis(ap, mi, axis=1),
        np.take_along_axis(ag, mi, axis=1),
    )


def build_distributed_solver(nshards: int, rounds: int = 16,
                             cand_width: int = 32,
                             slots_per_type: Optional[int] = None,
                             device: str = "cuda"):
    """Returns fn(task_prio [S,K], task_type [S,K], req_mask [NR,T],
    req_valid [NR]) -> assign [NR] of global task ids (-1 = none), with
    the task tables cut into ``nshards`` shards on ``device``.

    Server rows that are not a multiple of the shard count are padded with
    empty rows automatically (padding is appended, so real task ids are
    unchanged, and padded rows — priority floor, no type — can never win
    an assignment: nothing to strip from the returned plan)."""
    dev = check_device(device)

    def solve(task_prio, task_type, req_mask, req_valid):
        task_prio = np.asarray(task_prio)
        task_type = np.asarray(task_type)
        req_mask = np.asarray(req_mask)
        req_valid = np.asarray(req_valid)
        S, K = task_prio.shape
        NR, T = req_mask.shape
        pad = (-S) % nshards
        if pad:
            task_prio = np.concatenate(
                [task_prio,
                 np.full((pad, K), int(_NEG), task_prio.dtype)])
            task_type = np.concatenate(
                [task_type, np.full((pad, K), -1, task_type.dtype)])
        m = cand_width
        C, D = _slot_sizes(slots_per_type, m, rounds, NR)
        Sl = task_prio.shape[0] // nshards
        tp = torch.from_numpy(task_prio.astype(np.int32)).to(dev)
        tt = torch.from_numpy(task_type.astype(np.int32)).to(dev)
        # row index as rank: the functional path has no slot reuse, so
        # gid = si * K + ki exactly as before
        rk = torch.arange(task_prio.shape[0], dtype=torch.int32, device=dev)
        cp, cg = _shard_candidates(tp.view(nshards, Sl, K),
                                   tt.view(nshards, Sl, K),
                                   rk.view(nshards, Sl), T, D)
        both = torch.stack((cp, cg)).cpu().numpy()
        gp, gg = _merge_shard_major(both[0], both[1])
        rw, lens = _reqwin(req_mask, req_valid, T, C)
        req_open = req_valid.copy()
        assigned = _host_auction(gp, gg, rw, lens, req_open, rounds, m)
        assign = np.full((NR,), -1, dtype=np.int32)
        t_idx, c_idx = np.nonzero(assigned >= 0)
        assign[rw[t_idx, c_idx]] = assigned[t_idx, c_idx]
        return assign

    return solve


class _Staged:
    """A device buffer fed from a pinned host twin (on a card): numpy writes
    the host side, and each upload is one asynchronous host-to-device copy
    of its first bytes. :meth:`wait` holds the next write until the last
    copy has landed."""

    def __init__(self, nbytes: int, device: torch.device) -> None:
        cuda = device.type == "cuda"
        self.host = torch.zeros((max(nbytes, 1),), dtype=torch.uint8,
                                pin_memory=cuda)
        self.dev = torch.zeros((max(nbytes, 1),), dtype=torch.uint8,
                               device=device)
        self.np = self.host.numpy()
        self._landed = torch.cuda.Event() if cuda else None

    def wait(self) -> None:
        if self._landed is not None:
            self._landed.synchronize()

    def upload(self, nbytes: int) -> None:
        self.dev[:nbytes].copy_(self.host[:nbytes], non_blocking=True)
        if self._landed is not None:
            self._landed.record()


class DistributedAssignmentSolver:
    """Host wrapper mirroring AssignmentSolver.solve() but with the task
    table device-resident and cut into shards, updated incrementally from
    per-server snapshot deltas.

    ``solve(snapshots, world)`` is the engine-compatible entry: it diffs
    the snapshots against the resident state (``ingest``) — a stamp fast
    path skips unchanged servers outright when snapshots carry
    ``task_stamp``/``stamp`` (the engine forwards them), falling back to
    a tuple compare otherwise — ships only changed rows to the device,
    runs the fixed-shape planning round (``plan``), and unpacks plan
    entries. Phase timings land in ``last_ingest_ms`` /
    ``last_solve_ms`` / ``last_extract_ms`` for the obs gauges.

    Stamp fast-path caveat (documented contract): a server whose
    filtered task list changes with no stamp bump and no plan of ours
    touching it (engine plan-ledger TTL expiry) is picked up at its next
    snapshot — at most one idle-heartbeat interval late, well inside the
    protocol's plans-are-hints staleness tolerance."""

    #: the engine may hand solve() a LedgerView instead of a snapshot
    #: dict (array-resident host tier, balancer/ledger.py): ingest then
    #: copies packed rows for servers whose ledger generation moved —
    #: no tuple re-derivation, no stamp-key diffing
    SUPPORTS_VIEW = True

    #: changed-row count above which a plan re-sweeps the table on the
    #: device instead of patching the merged candidate lists in place
    DELTA_RESYNC_ROWS = 16
    #: force a full device sweep at least every this many plans, so the
    #: incremental candidate view can never drift unbounded (it is exact
    #: by construction; the resync is belt-and-braces + keeps the
    #: device path continuously exercised)
    RESYNC_INTERVAL = 64

    def __init__(
        self,
        types: Sequence[int],
        max_tasks_per_server: int,
        max_requesters: int,
        nshards: int = 1,
        rounds: int = 16,
        servers_per_shard: int = 1,
        cand_width: int = 32,
        slots_per_type: Optional[int] = None,
        auction: str = "device",
        max_jobs: int = 1,
        job_weights: Optional[dict] = None,
        device: str = "cuda",
    ) -> None:
        if auction not in ("device", "host"):
            raise ValueError(
                f"auction must be 'device' or 'host', got {auction!r}")
        if nshards < 1 or servers_per_shard < 1:
            raise ValueError("nshards and servers_per_shard must be >= 1")
        if cand_width < 1:
            raise ValueError(f"cand_width must be >= 1, got {cand_width}")
        self.device = check_device(device)
        self.auction = auction
        self.base_types = tuple(types)
        self.base_T = max(len(self.base_types), 1)
        self.max_jobs = max(int(max_jobs), 1)
        # composite (job, type) axis under multi-job planning — the
        # base types verbatim when single-job (balancer/jobdim.py);
        # the device steps see T' generic types and stay untouched
        self.types = expand_types(self.base_types, self.max_jobs)
        self.job_bias = bias_vector(job_weights, self.max_jobs)
        self.type_index = {t: i for i, t in enumerate(self.types)}
        self.K = max_tasks_per_server
        self.R = max_requesters
        self.nshards = nshards
        self.rounds = rounds
        self._Sl = servers_per_shard
        self.S = nshards * servers_per_shard
        T = max(len(self.types), 1)
        self.T = T
        self.m = cand_width
        NR = self.S * self.R
        self.C, self.D = _slot_sizes(
            slots_per_type, cand_width, rounds, NR)

        # ---- host mirrors of the resident device state ----
        self._tp = np.full((self.S, self.K), int(_NEG), dtype=np.int32)
        self._tt = np.full((self.S, self.K), -1, dtype=np.int32)
        self._req_valid = np.zeros((NR,), dtype=bool)
        self._req_mask = np.zeros((NR, T), dtype=bool)
        self._task_cache: dict[int, tuple] = {}
        self._req_cache: dict[int, tuple] = {}
        self._task_stamp: dict[int, float] = {}
        self._req_stamp: dict[int, float] = {}
        self._servers: list = []  # registered ranks (slot order free)
        self._si: dict[int, int] = {}
        # rank behind each resident row (-1 = free): the gid key space.
        # Slots are free-listed, never remapped — the auction tie-break
        # is the rank-keyed gid, not the row index
        self._row_rank = np.full((self.S,), -1, dtype=np.int64)
        self._free_si: list[int] = []
        self._next_si = 0
        # ranks whose candidate entries the next host-tier patch must
        # drop (a freed slot's row_rank is already recycled by then)
        self._dropped_ranks: set = set()
        # rank-sorted requester row order (see _reqwin): rebuilt only
        # when membership changes — the requester tie-break, like the
        # task gid, must follow rank order, not physical slot order
        self._row_perm: Optional[np.ndarray] = None
        self._task_ref: list = [[None] * self.K for _ in range(self.S)]
        self._req_ref: list = [None] * NR
        self._reqs_dirty = True
        # servers whose tasks/reqs our own last plan consumed: their
        # ledger-filtered snapshot content changes without a stamp bump
        self._planned_servers: set = set()
        # view-ingest bookkeeping: the ledger membership generation and
        # per-slot task/req generations last consumed (slot-indexed
        # arrays, diffed vectorized; generations are globally monotonic
        # so a slot reused for a new rank can never alias)
        self._seen_member_gen = None
        self._seen_tgen: Optional[np.ndarray] = None
        self._seen_rgen: Optional[np.ndarray] = None

        # device state, allocated lazily (constructing a solver must not
        # touch the card before first use): the resident table [S, 2K+1]
        # int32 (prios, types, then the row's rank), its views as
        # [nshards, Sl, ...] blocks, the pinned staging of changed rows
        self._dev_tab: Optional[torch.Tensor] = None
        self._dev_blocks: Optional[tuple] = None
        self._rows: Optional[_Staged] = None
        # device-tier requester tables (rebuilt when reqs change):
        # compacted reqwin + lengths + initial open vector, one upload
        self._rwc: Optional[np.ndarray] = None
        self._open0: Optional[np.ndarray] = None
        self._reqbuf: Optional[_Staged] = None
        self._dev_req: Optional[tuple] = None
        # the auction kernel's buffers (device tier on a card)
        self._work: Optional[_auction.Workspace] = None
        # merged per-type candidate lists [T, nshards*D] (prio desc, gid
        # asc, _NEG-padded): materialized by the device sweep, patched
        # in place for small deltas (exactly what a sweep would produce
        # — asserted by tests), re-swept when a delta is large or every
        # RESYNC_INTERVAL plans
        self._gp: Optional[np.ndarray] = None
        self._gg: Optional[np.ndarray] = None
        self._cand_dirty = True
        self._plans_since_sweep = 0
        self.sweep_count = 0
        # why each host-tier re-sweep ran (obs: solver_resweeps counter;
        # the device tier regenerates candidates every plan on-device,
        # so it never re-sweeps and these stay zero)
        self.sweep_reasons: dict = {"cold": 0, "delta": 0, "cadence": 0}
        self.last_sweep_ms = 0.0

        self.last_ingest_ms = 0.0
        self.last_solve_ms = 0.0
        self.last_extract_ms = 0.0
        self.solve_count = 0

    # ------------------------------------------------------------------
    def set_job_bias(self, job_weights: Optional[dict]) -> bool:
        """Install new fair-share biases and invalidate every cached
        task row (packed prios embed the bias; the stamp/tuple caches
        compare RAW snapshot tuples, which a weight change does not
        touch — so they must be dropped, not diffed). The view path
        needs no flush here: a weight change forces the ledger's own
        full rebuild, which bumps every slot generation."""
        bias = bias_vector(job_weights, self.max_jobs)
        if bias == self.job_bias:
            return False
        self.job_bias = bias
        self._task_cache.clear()
        self._task_stamp.clear()
        self._cand_dirty = True
        return True

    def _ensure_built(self) -> None:
        if self._dev_tab is not None:
            return
        dev, S, K, T, C = self.device, self.S, self.K, self.T, self.C
        ns, Sl = self.nshards, self._Sl
        # the host mirror's initial state: every row free (priority
        # floor, no type, rank 0 — free rows are dead, so their gids can
        # never surface as candidates)
        tab = torch.zeros((S, 2 * K + 1), dtype=torch.int32, device=dev)
        tab[:, :K] = _NEG
        tab[:, K:2 * K] = -1
        self._dev_tab = tab
        self._dev_blocks = (tab[:, :K].reshape(ns, Sl, K),
                            tab[:, K:2 * K].reshape(ns, Sl, K),
                            tab[:, 2 * K].reshape(ns, Sl))
        # a delta ships its changed rows (with their row index in the
        # last column) in one copy, then one index_copy_ on the device
        self._rows = _Staged(4 * S * (2 * K + 2), dev)
        self._rows_np = self._rows.np.view(np.int32)[:S * (2 * K + 2)] \
            .reshape(S, 2 * K + 2)
        self._rows_dev = self._rows.dev.view(torch.int32)[:S * (2 * K + 2)] \
            .view(S, 2 * K + 2)
        if self.auction == "device":
            U = T * C
            self._req_bytes = 4 * T * C + 4 * T + U + 1
            self._reqbuf = _Staged(self._req_bytes, dev)
            b = self._reqbuf.dev
            self._dev_req = (
                b[:4 * T * C].view(torch.int32).view(T, C),
                b[4 * T * C:4 * T * (C + 1)].view(torch.int32),
                b[4 * T * (C + 1):self._req_bytes].view(torch.bool))
            if dev.type == "cuda":
                self._work = _auction.Workspace(T, C, self.m, dev)

    def _upload_rows(self, changed) -> None:
        """Ship the changed rows of the host mirror to the resident table:
        one host-to-device copy of the rows and their indices, one
        ``index_copy_``; the rest of the table stays where it is."""
        rows = np.unique(np.asarray(changed, dtype=np.int64))
        n, K = rows.size, self.K
        self._rows.wait()
        buf = self._rows_np
        buf[:n, :K] = self._tp[rows]
        buf[:n, K:2 * K] = self._tt[rows]
        buf[:n, 2 * K] = np.maximum(self._row_rank[rows], 0)
        buf[:n, 2 * K + 1] = rows
        self._rows.upload(4 * n * (2 * K + 2))
        staged = self._rows_dev[:n]
        self._dev_tab.index_copy_(0, staged[:, 2 * K + 1].long(),
                                  staged[:, :2 * K + 1])

    def _map_server(self, s) -> Optional[int]:
        si = self._si.get(s)
        if si is not None:
            return si
        if self._free_si:
            si = self._free_si.pop()
        elif self._next_si < self.S:
            si = self._next_si
            self._next_si += 1
        else:
            # beyond capacity: unmapped until a registered server dies
            # (ingest still re-diffs every REGISTERED server each
            # round, so capacity overflow never leaves stale resident
            # rows — only unplanned extras)
            return None
        if s * self.K + self.K - 1 > _I32MAX:
            raise ValueError(
                f"server rank {s} overflows the int32 gid space "
                f"(rank * max_tasks_per_server must stay under 2**31)")
        # slots are free-listed and NEVER remapped: the auction
        # tie-break is the rank-keyed gid (rank * K + ki), not the row
        # index, so an elastic join patches one row instead of
        # re-packing the world
        self._servers.append(s)
        self._si[s] = si
        self._row_rank[si] = s
        self._row_perm = None  # rank order changed: rebuild lazily
        return si

    def _unregister(self, s, changed: list) -> None:
        """A vanished server (drain/failover): clear its resident rows
        and recycle the slot. Rank-keyed gids make this purely local —
        no other row moves, and the slot's next tenant brings its own
        gid range."""
        si = self._si.pop(s)
        self._servers.remove(s)
        if (self._tp[si] > int(_NEG)).any():
            changed.append(si)
            # the host-tier candidate patch must drop this rank's
            # entries even after row_rank forgets it
            self._dropped_ranks.add(int(s))
        self._tp[si, :] = int(_NEG)
        self._tt[si, :] = -1
        self._task_ref[si] = [None] * self.K
        base = si * self.R
        if self._req_valid[base:base + self.R].any():
            self._req_valid[base:base + self.R] = False
            self._req_mask[base:base + self.R, :] = False
            for i in range(self.R):
                self._req_ref[base + i] = None
            self._reqs_dirty = True
        self._task_cache.pop(s, None)
        self._req_cache.pop(s, None)
        self._task_stamp.pop(s, None)
        self._req_stamp.pop(s, None)
        self._row_rank[si] = -1
        self._free_si.append(si)
        self._row_perm = None  # rank order changed: rebuild lazily

    def _pack_tasks(self, s: int, tasks: tuple) -> None:
        si = self._si[s]
        row_p = self._tp[si]
        row_t = self._tt[si]
        row_p.fill(int(_NEG))
        row_t.fill(-1)
        ref = self._task_ref[si]
        for ki in range(self.K):
            ref[ki] = None
        # task tuples are (seqno, type, prio, len) — a 5th (job)
        # element rides along under multi-job planning; index, don't
        # unpack. The composite index / weight bias handling is the
        # exact twin of solve.py's dict packer and ledger._rebuild_tasks
        J, bias, nb = self.max_jobs, self.job_bias, len(self.job_bias)
        for ki, tk in enumerate(tasks[: self.K]):
            seqno, wtype, prio = tk[0], tk[1], tk[2]
            jb = (tk[4] if len(tk) > 4 else 0) if J > 1 else 0
            b = bias[jb] if 0 <= jb < nb else 0
            row_p[ki] = max(-_PRIO_CLIP, min(_PRIO_CLIP, prio)) + b
            row_t[ki] = self.type_index.get(
                wtype if J <= 1 else (jb, wtype), -1)
            ref[ki] = (s, seqno)
        self._task_cache[s] = tasks

    def _pack_reqs(self, s: int, reqs: tuple) -> None:
        si = self._si[s]
        R = self.R
        base = si * R
        self._req_valid[base: base + R] = False
        self._req_mask[base: base + R, :] = False
        for ri in range(R):
            self._req_ref[base + ri] = None
        J, T0 = self.max_jobs, self.base_T
        for ri, req in enumerate(reqs[:R]):
            # req tuples are (rank, rqseqno, types|None) — a 4th
            # (fused-reserve) element may ride along, and a 5th (job)
            # under multi-job planning; index, don't unpack. Job
            # handling twins ledger._rebuild_reqs exactly: any-type =
            # job-block mask, overflow job = empty mask
            rank, rqseqno, req_types = req[0], req[1], req[2]
            jb = (req[4] if len(req) > 4 else 0) if J > 1 else 0
            i = base + ri
            self._req_valid[i] = True
            if J > 1 and not 0 <= jb < J:
                pass  # overflow job: planner-invisible
            elif req_types is None:
                if J <= 1:
                    self._req_mask[i, :] = True
                else:
                    self._req_mask[i, jb * T0:(jb + 1) * T0] = True
            else:
                for t in req_types:
                    ti = self.type_index.get(t if J <= 1 else (jb, t))
                    if ti is not None:
                        self._req_mask[i, ti] = True
            self._req_ref[i] = (s, rank, rqseqno)
        self._req_cache[s] = reqs
        self._reqs_dirty = True

    # ------------------------------------------------------------------
    def ingest(self, snapshots: dict) -> int:
        """Diff snapshots against the resident state; ship only changed
        server rows to the device. Returns changed-row count."""
        t0 = time.perf_counter()
        self._ensure_built()
        changed: list[int] = []
        planned = self._planned_servers
        # every snapshot is OFFERED a row (registered servers always
        # keep theirs; new ones register while capacity lasts, extras
        # map to None). Slicing to the lowest-S ranks here instead
        # would strand a registered server outside the slice: still in
        # `snapshots`, so the vanished-server sweep below never clears
        # it, and its frozen rows would keep winning auctions.
        for s in sorted(snapshots):
            si = self._map_server(s)
            if si is None:
                continue
            snap = snapshots[s]
            # the key tuples pair the snapshot stamps with the
            # event-delta sequences (in-place snapshot mutations carry
            # no stamp bump — see server._merge_task_delta) and the
            # engine's ledger stamp (our plans change the filtered view
            # with no snapshot at all). Compared for (in)equality ONLY:
            # the components come from different hosts' monotonic
            # clocks, so ordering across them is meaningless.
            led = snap.get("ledger_stamp")
            tstamp = snap.get("task_stamp", snap.get("stamp"))
            tkey = (tstamp, snap.get("delta_seq", 0), led)
            if (
                tstamp is None
                or s in planned
                or self._task_stamp.get(s) != tkey
            ):
                tasks = tuple(map(tuple, snap["tasks"][: self.K]))
                if self._task_cache.get(s) != tasks:
                    self._pack_tasks(s, tasks)
                    changed.append(self._si[s])
                if tstamp is not None:
                    self._task_stamp[s] = tkey
            rstamp = snap.get("stamp")
            rkey = (rstamp, snap.get("req_seq", 0), led)
            if (
                rstamp is None
                or s in planned
                or self._req_stamp.get(s) != rkey
            ):
                reqs = tuple(map(tuple, snap["reqs"][: self.R]))
                if self._req_cache.get(s) != reqs:
                    self._pack_reqs(s, reqs)
                if rstamp is not None:
                    self._req_stamp[s] = rkey
        planned.clear()
        # servers that vanished (failover): unregister — clear their
        # rows AND free the slot for the next join. Checked every
        # ingest (O(S) dict lookups) — gating on a shrinking snapshot
        # COUNT missed a death that coincides with another server
        # joining, or a world larger than capacity S, leaving a dead
        # server's resident rows winning auctions forever
        for s in [r for r in self._servers if r not in snapshots]:
            self._unregister(s, changed)
        self._finish_ingest(changed)
        self.last_ingest_ms = (time.perf_counter() - t0) * 1e3
        return len(changed)

    def _finish_ingest(self, changed: list) -> None:
        """Shared ingest tail (tuple and view paths): ship changed rows,
        patch or dirty the host tier's merged candidate lists, rebuild
        the requester slot windows."""
        if changed:
            self._upload_rows(changed)
            if self.auction == "device":
                # the device tier regenerates candidates from the
                # resident table every plan — nothing to patch
                self._dropped_ranks.clear()
            elif (
                self._gp is None
                or len(changed) > max(self.DELTA_RESYNC_ROWS, self.nshards)
            ):
                self._cand_dirty = True
            else:
                self._patch_candidates(changed)
        if self._reqs_dirty:
            if self._row_perm is None:
                # rank-sorted slots first, then the unused slots (all
                # their rows invalid — order among them is irrelevant)
                used = sorted(self._si.items())  # (rank, si) rank-asc
                rest = sorted(
                    set(range(self.S)) - {si for _, si in used})
                slot_seq = np.asarray(
                    [si for _, si in used] + rest, dtype=np.int64)
                self._row_perm = (
                    slot_seq[:, None] * self.R
                    + np.arange(self.R, dtype=np.int64)[None, :]
                ).reshape(-1)
            self._rw, self._lens = _reqwin(
                self._req_mask, self._req_valid, self.T, self.C,
                self._row_perm)
            if self.auction == "device":
                self._build_req_tables()
            self._reqs_dirty = False

    def _build_req_tables(self) -> None:
        """Device-tier requester tables (:func:`_compact_reqwin`), then one
        upload of the tables, the lengths and the open vector."""
        self._rwc, self._open0 = _compact_reqwin(self._rw)
        self._reqbuf.wait()
        b, tc = self._reqbuf.np, 4 * self.T * self.C
        b[:tc].view(np.int32)[:] = self._rwc.reshape(-1)
        b[tc:tc + 4 * self.T].view(np.int32)[:] = self._lens
        b[tc + 4 * self.T:self._req_bytes] = self._open0
        self._reqbuf.upload(self._req_bytes)

    def _ingest_view(self, view) -> int:
        """Delta ingest from the engine's array-resident host ledger:
        copy the packed rows of every slot whose ledger generation
        moved since we last consumed it. The ledger already applied the
        plan-mark/suppression filtering, so there is no stamp-key
        bookkeeping and no tuple compare here — the generation counters
        ARE the change signal (they cover in-place deltas, dead-rank
        patches, and the engine's own plan touches alike).

        Fully vectorized: the changed-slot set is two numpy compares
        against the seen-generation mirrors, and the O(S) membership
        walk runs only when the ledger's ``member_gen`` moved (churn) —
        a steady-state round does O(changed) python work, which is what
        holds the idle planning round flat at 10k servers."""
        t0 = time.perf_counter()
        self._ensure_built()
        # layout agreement is load-bearing: refs index [K]/[R] rows
        assert (view.K, view.R, tuple(view.types)) == (
            self.K, self.R, self.types)
        changed: list[int] = []
        ncap = view.t_gen.shape[0]
        if (
            view.member_gen != self._seen_member_gen
            or self._seen_tgen is None
            or self._seen_tgen.shape[0] != ncap
        ):
            # membership walk (cold start / churn / ledger realloc):
            # register joins, unregister vanished ranks (a death may
            # coincide with a join or a beyond-capacity world, so the
            # check is membership-exact, not count-based), grow the
            # seen-generation mirrors
            fresh: list = []
            for s in view.servers:
                if s not in self._si and self._map_server(s) is not None:
                    fresh.append(s)
            sset = set(view.servers)
            for s in [r for r in self._servers if r not in sset]:
                self._unregister(s, changed)
            old_t, old_r = self._seen_tgen, self._seen_rgen
            self._seen_tgen = np.zeros(ncap, np.int64)
            self._seen_rgen = np.zeros(ncap, np.int64)
            if old_t is not None:
                n = min(old_t.shape[0], ncap)
                self._seen_tgen[:n] = old_t[:n]
                self._seen_rgen[:n] = old_r[:n]
            for s in fresh:
                # a rank we just registered (join, or an extra that
                # finally got capacity): its slot gens may predate our
                # mirror — force the copy (gen 0 precedes every bump)
                slot = view.slot_of(s)
                self._seen_tgen[slot] = 0
                self._seen_rgen[slot] = 0
            self._seen_member_gen = view.member_gen
        R = self.R
        slot_rank = view.slot_rank
        for slot in np.flatnonzero(
                view.t_gen != self._seen_tgen).tolist():
            self._seen_tgen[slot] = view.t_gen[slot]
            si = self._si.get(int(slot_rank[slot]))
            if si is None:
                continue  # freed slot, or beyond-capacity extra
            self._tp[si, :] = view.pk_tp[slot]
            self._tt[si, :] = view.pk_tt[slot]
            self._task_ref[si] = list(view.pk_trefs[slot])
            changed.append(si)
        for slot in np.flatnonzero(
                view.r_gen != self._seen_rgen).tolist():
            self._seen_rgen[slot] = view.r_gen[slot]
            si = self._si.get(int(slot_rank[slot]))
            if si is None:
                continue
            base = si * R
            self._req_valid[base:base + R] = view.pk_rv[slot]
            self._req_mask[base:base + R, :] = view.pk_rm[slot]
            rrefs = view.pk_rrefs[slot]
            for i in range(R):
                self._req_ref[base + i] = rrefs[i]
            self._reqs_dirty = True
        # plan() keeps recording its touches for the tuple path; the
        # view path's generations already carry them — drop so the set
        # cannot grow unboundedly
        self._planned_servers.clear()
        self._finish_ingest(changed)
        self.last_ingest_ms = (time.perf_counter() - t0) * 1e3
        return len(changed)

    def _patch_candidates(self, changed: list) -> None:
        """Patch the merged candidate lists for a small delta by
        re-merging every AFFECTED SHARD whole from the host mirror —
        not just the changed servers' rows: a sweep's per-shard top-D
        window can have excluded a shard-mate's lower-priority tasks,
        and when a delta drains the shard's top entries those must
        resurface immediately, not at the next resync. The result
        equals (is a superset of, truncated at the same capacity) what
        a fresh sweep would produce down to every auction-reachable
        rank (D), as long as a type's list stays under its capacity L.
        A type that saturates L gets truncated at the TAIL (still exact
        to depth D this round) and flags a full re-sweep for the next
        plan, so deep-tail entries can never silently go missing across
        rounds."""
        K = self.K
        Sl = self._Sl
        gp, gg = self._gp, self._gg
        L = gp.shape[1]
        # shards whose sweep window truncated nothing hold ALL their
        # live entries in the merged lists, so patching just the
        # changed servers' rows is exact and O(delta). A truncated
        # shard must re-merge WHOLE from the host mirror (its
        # shard-mates' beyond-window tasks may need to resurface) —
        # after which it is complete and drops out of the set.
        heavy = sorted({
            d for d in {si // Sl for si in changed}
            if self._shard_trunc[d]
        })
        row_set = sorted(
            set(changed)
            | {r for d in heavy for r in range(d * Sl, (d + 1) * Sl)}
        )
        rows = np.asarray(row_set, dtype=np.int64)
        # entries are dropped by the RANK their gid carries — the
        # affected rows' current tenants plus any rank whose slot was
        # freed since the last patch (its row_rank is already recycled)
        ranks = {int(r) for r in self._row_rank[rows] if r >= 0}
        ranks |= self._dropped_ranks
        self._dropped_ranks = set()
        drop = np.isin(
            gg // K, np.asarray(sorted(ranks), dtype=np.int64)
        ) & (gp > int(_NEG))
        for d in heavy:
            self._shard_trunc[d] = False
        # fresh entries: the affected rows' blocks from the host mirror
        # (freed rows carry rank -1 — negative gids, excluded by `live`)
        new_gid = (self._row_rank[rows][:, None] * K
                   + np.arange(K, dtype=np.int64)[None, :]).reshape(-1)
        new_p = self._tp[rows].reshape(-1)
        new_t = self._tt[rows].reshape(-1)
        live = (new_p > int(_NEG)) & (new_t >= 0)
        for t in range(self.T):
            sel = live & (new_t == t)
            keep = ~drop[t] & (gp[t] > int(_NEG))
            merged_p = np.concatenate([gp[t][keep], new_p[sel]])
            merged_g = np.concatenate([gg[t][keep], new_gid[sel]])
            # stable prio sort alone is not gid-exact across the two
            # concatenated pieces; sort one composite (prio, -gid) key,
            # then truncate the sorted result to capacity (never the
            # kept list before merging — that dropped live candidates)
            ck = merged_p.astype(np.int64) * (1 << 32) + (
                (1 << 32) - 1 - merged_g)
            order = np.argsort(-ck)[:L]
            n = order.shape[0]
            if merged_p.shape[0] > L:
                self._cand_dirty = True  # saturated: re-sweep next plan
            gp[t, :n] = merged_p[order]
            gg[t, :n] = merged_g[order]
            gp[t, n:] = int(_NEG)
            gg[t, n:] = _I32MAX

    def _sweep(self) -> None:
        """Full device sweep: the sharded candidate generation on the
        device plus the ONE device->host transfer of the planning round,
        re-materializing the merged candidate lists."""
        t0 = time.perf_counter()
        cp, cg = _shard_candidates(*self._dev_blocks, self.T, self.D)
        both = torch.stack((cp, cg)).cpu().numpy()
        self._gp, self._gg = _merge_shard_major(both[0], both[1])
        self._dropped_ranks.clear()  # re-materialized from live rows
        self._gg = self._gg.astype(np.int64)
        self._gp = self._gp.astype(np.int64)
        # which shards' top-D windows truncated anything: per-(shard,
        # type) live counts over the host mirror (one bincount)
        live = (self._tp > int(_NEG)) & (self._tt >= 0)
        shard_ids = np.repeat(
            np.arange(self.nshards, dtype=np.int64), self._Sl * self.K)
        keys = shard_ids[live.reshape(-1)] * self.T + np.clip(
            self._tt.reshape(-1)[live.reshape(-1)], 0, self.T - 1)
        counts = np.bincount(keys, minlength=self.nshards * self.T)
        self._shard_trunc = (
            counts.reshape(self.nshards, self.T) > self.D).any(axis=1)
        self._cand_dirty = False
        self._plans_since_sweep = 0
        self.sweep_count += 1
        self.last_sweep_ms = (time.perf_counter() - t0) * 1e3

    def _device_plan(self) -> np.ndarray:
        """The device-tier planning round: candidates of every shard, the
        merge (one sort), one auction launch (the plain version on the
        CPU), one [T, C+1] readback."""
        cp, cg = _shard_candidates(*self._dev_blocks, self.T, self.D)
        gp, gg = _merge_candidates(cp, cg)
        rwc, lens, open0 = self._dev_req
        assigned = _auction.auction(gp, gg, rwc, lens, open0, self.rounds,
                                    self.m, work=self._work)
        return assigned.cpu().numpy()[:, : self.C]

    def plan(self) -> list:
        """One fixed-shape planning round over the resident state."""
        if not self._req_valid.any():
            return []
        t0 = time.perf_counter()
        self._ensure_built()
        if self.auction == "device":
            assigned = self._device_plan()
        else:
            if (
                self._cand_dirty
                or self._plans_since_sweep >= self.RESYNC_INTERVAL
            ):
                self.sweep_reasons[
                    "cold" if self._gp is None
                    else "delta" if self._cand_dirty
                    else "cadence"] += 1
                self._sweep()
            self._plans_since_sweep += 1
            req_open = self._req_valid.copy()
            assigned = _host_auction(
                self._gp, self._gg, self._rw, self._lens, req_open,
                self.rounds, self.m)
        t1 = time.perf_counter()
        self.last_solve_ms = (t1 - t0) * 1e3
        pairs = []
        t_idx, c_idx = np.nonzero(assigned >= 0)
        gids = assigned[t_idx, c_idx].tolist()
        rids = self._rw[t_idx, c_idx].tolist()
        K = self.K
        for g, rid in zip(gids, rids):
            rank, ki = divmod(int(g), K)
            si = self._si.get(rank)
            tref = self._task_ref[si][ki] if si is not None else None
            rref = self._req_ref[rid]
            if tref is None or rref is None:
                continue
            holder, seqno = tref
            req_home, for_rank, rqseqno = rref
            pairs.append((holder, seqno, req_home, for_rank, rqseqno))
            self._planned_servers.add(holder)
            self._planned_servers.add(req_home)
        self.last_extract_ms = (time.perf_counter() - t1) * 1e3
        self.solve_count += 1
        return pairs

    def solve(self, snapshots, world) -> list:
        """Engine-compatible one-call path: ingest deltas, then plan.
        Accepts either the filtered-snapshot dict or the engine's
        array-resident ledger view."""
        if getattr(snapshots, "is_array", False):
            self._ingest_view(snapshots)
        else:
            self.ingest(snapshots)
        return self.plan()
