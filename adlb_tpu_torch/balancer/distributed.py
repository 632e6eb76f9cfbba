"""The sharded planner: the assignment solve over a task table cut into
shards, the JAX package's ``balancer/distributed.py`` on the card.

The task table — the big axis, servers x queue depth — is device-resident,
cut by server into ``nshards`` shards of ``servers_per_shard`` rows each,
and updated *incrementally* from per-server snapshot deltas (only changed
rows ship; unchanged servers are skipped by a stamp fast path). Where the
shards live is the solver's placement:

- ``devices`` (a list of cards, or of "cpu" for tests): shard i is a piece
  of the table resident on ``devices[i]``, as the JAX package keeps one
  block per device of its mesh. Each card generates its own shard's
  candidates, the planning device (``device``, ``devices[0]`` unless given)
  gathers the cards' lists and merges them, and plans. This is what
  :class:`~adlb_tpu_torch.balancer.engine.PlanEngine` builds with one shard
  per visible card.
- no ``devices``: ``nshards`` logical shards on the one ``device``, a batch
  dimension of one table (the single-card twin the tests and the logical
  ``nshards`` of ``plan_bench`` use).

Each planning round is three fixed-shape steps:

1. **sharded candidate generation** — every shard's top-D candidates of
   each type by (priority desc, gid), D = C + m + 1
   (:mod:`adlb_tpu_torch.balancer.candidates`).
2. **cross-shard merge** of the [nshards, T, D] per-shard candidates into
   global per-type lists ordered by (prio desc, gid asc). The elastic slot
   map decouples row order from rank order, so gid order is part of the
   key.
3. **auction rounds** — pure head-pointer logic over the merged per-type
   candidate lists and the [T, C] requester-slot tables (O(plan size)):
   rank-k candidate pairs with the k-th open accepting requester,
   cross-type conflicts resolve by (prio, -gid), a global threshold
   defers any winner that a displaced higher-priority task could cascade
   into, and prefix commits keep every shard's consumed tasks a prefix
   of its sorted type segment (which is what makes step 1's head slices
   exact).

The solver runs one of two tiers over those steps:

- ``auction="device"`` (default): all three steps run on the cards as
  launches of hand-written CUDA kernels — with logical shards steps 1-2 as
  one launch of ``csrc/candidates.cu`` (each type's merge cut to its first
  D entries, all the auction reads); across cards step 1 as one launch of
  the same kernel on each card over its shard, a gather of each card's
  [2, T, D] lists onto the planning card (a copy, not an all-gather: the
  merge and the auction run once, where the JAX program replicates them on
  every device) and step 2 as one launch of its merge alone; step 3 as one
  launch of ``csrc/auction.cu`` (:mod:`adlb_tpu_torch.balancer.auction`)
  on the planning card, whose prologue builds the requester windows from
  the requester table resident there (:class:`_Requesters`: each ingest
  ships the rewritten servers' rows, the kernel applies them) and gives
  their rows dense ids (U = T*C distinct ids at most, so the per-round
  scatters never touch O(requesters) state); it builds the windows of the
  live types alone (those with a candidate this plan: a type without one
  commits nothing) and stops its scan once each of those holds C rows, so
  a type that few requesters accept and no task needs costs no scan of
  the whole table; their plain torch versions on ``"cpu"``. A planning
  round ends in one readback of [2, T, C+1] and three counts (the commits,
  each slot's requester row, the rounds run, the rows scanned and the
  entries lost to another type) — no sort on the card, no per-round host
  merge, no host window scan, no O(S) host work.
- ``auction="host"``: the retained twin — steps 2-3 on the planner host
  (numpy), with the merged candidate lists cached and patched in place
  between device sweeps (step 1 on the cards, each card's per-shard lists
  read back), over every type's window (:func:`_reqwin`). The twin is what
  the device tier is fuzz-checked against (exact same commits from the
  same state; the device tier's windows of the live types equal the
  twin's, the others are empty).

Task ids are **rank-keyed**: gid = rank * K + ki (``row_rank`` maps the
resident row to its server rank; int32 on device, so rank * K must stay
under 2**31 — enforced at registration). Because the greedy tie-break is
the gid order itself, slot assignment is free-listed: an elastic join or
leave patches exactly one row and never remaps the world — no full
re-sweep on churn.

The auction reproduces the exact sequential greedy matching of
:func:`adlb_tpu_torch.balancer.solve._host_greedy` — same matched
requester set, same committed task multiset, same total score
(``tests/test_torch_distributed.py`` at 1, 2 and 8 shards;
``tests/test_torch_multidevice.py`` across 2, 3 and 8 pieces) — truncation
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

import contextlib
from typing import Optional, Sequence

import numpy as np

import torch

from adlb_tpu_torch.balancer import auction as _auction
from adlb_tpu_torch.balancer import candidates as _candidates
from adlb_tpu_torch.balancer import cuda_build as _cuda_build
from adlb_tpu_torch.balancer import staged_copy as _staged_copy
from adlb_tpu_torch.balancer.candidates import (  # noqa: F401  (plain versions)
    _merge_candidates, _shard_candidates)
from adlb_tpu_torch.balancer.jobdim import bias_vector, expand_types
from adlb_tpu_torch.balancer.solve import (
    _I32MAX, _NEG, _PRIO_CLIP, check_device)
from adlb_tpu_torch.runtime.trace import clock


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
    """The auction's requester tables from ``reqwin [T, C]``: the row ids
    compacted to a dense [0, U) id space (U = T*C static; U itself is the
    dump id and marks an empty slot), so the auction's winner/open scatters
    are a few KB, independent of the requester-table depth. Returns (rwc
    [T, C] int32, open0 [U + 1] bool: True for every real compacted id).
    The device tier's auction builds its tables in its prologue instead
    (ids in scan order, the same commits); this host version is the
    reference the tests and ``chip_smoke.py`` hold the kernel to."""
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


#: an ingest's trace record without an upload / requester windows or rows
_NO_UPLOAD = (None,) * 5
_NO_REQWIN = (None,) * 5
#: a plan's trace record without a device plan (host tier)
_NO_DEVICE_PLAN = (None,) * 8


def _ingest_spans(rec: tuple) -> list:
    """The spans of one ingest's trace record (``Tracer.defer``): the
    ingest and its diff, pack, upload and, where they ran, the host tier's
    requester windows or the device tier's requester rows."""
    (rnd, path, t0, t1, t2, t3, walked, task_changed, req_changed,
     servers_changed, vanished, task_rows, req_servers, req_rows,
     u0, u1, rows, nbytes, pieces, w0, w1, w_rows, w_bytes, w_flag) = rec
    p = "planner:ingest"
    diff = {"round": rnd, "parent": p, "walked": walked,
            "task_changed": task_changed, "req_changed": req_changed,
            "servers_changed": servers_changed}
    if vanished is not None:
        diff["vanished"] = vanished
    out = [(p + ".diff", t0, t1, diff),
           (p + ".pack", t1, t2, {"round": rnd, "parent": p,
                                  "task_rows": task_rows,
                                  "req_servers": req_servers,
                                  "req_rows": req_rows})]
    if u0 is not None:
        out.append((p + ".upload", u0, u1, {"round": rnd, "parent": p,
                                            "rows": rows, "bytes": nbytes,
                                            "pieces": pieces}))
    if w0 is not None and w_rows is None:
        out.append((p + ".reqwin", w0, w1, {"round": rnd, "parent": p,
                                            "bytes": w_bytes,
                                            "perm_rebuilt": w_flag}))
    elif w0 is not None:
        out.append((p + ".reqrows", w0, w1, {"round": rnd, "parent": p,
                                             "rows": w_rows,
                                             "bytes": w_bytes,
                                             "order_uploaded": w_flag}))
    out.append((p, t0, t3, {"round": rnd, "parent": None, "path": path,
                            "walked": walked}))
    return out


def _plan_spans(rec: tuple) -> list:
    """The spans of one plan's trace record (``Tracer.defer``): the plan,
    its device plan's enqueue and readback (or the host tier's sweep and
    auction) and the extraction."""
    (rnd, t0, t1, t2, pairs, swept, e0, e1, e2, launches, nbytes,
     scanned, auction_rounds, lost) = rec
    p = "planner:plan"
    if e0 is not None:
        out = [(p + ".enqueue", e0, e1, {"round": rnd, "parent": p,
                                         "launches": launches}),
               (p + ".readback", e1, e2, {"round": rnd, "parent": p,
                                          "bytes": nbytes,
                                          "scanned": scanned,
                                          "rounds": auction_rounds,
                                          "lost": lost})]
    else:
        out = [(p + ".host", t0, t1, {"round": rnd, "parent": p,
                                      "swept": swept})]
    out.append((p + ".extract", t1, t2, {"round": rnd, "parent": p,
                                         "pairs": pairs}))
    out.append((p, t0, t2, {"round": rnd, "parent": None, "pairs": pairs}))
    return out


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
        cp, cg = _candidates.shard_candidates(tp.view(nshards, Sl, K),
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


def _on(device: torch.device):
    """``device`` made current for what follows, on a card (CUDA events,
    streams and ctypes launches belong to the current card); nothing on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _placement(devices, device) -> tuple:
    """(shard devices, planning device) of a solver given ``devices``: all
    of one type, the planning device of that type too and ``devices[0]``
    when ``device`` names no card. Raises on a mixed list."""
    devs = [torch.device(d) for d in devices]
    kinds = sorted({d.type for d in devs})
    if not devs or len(kinds) != 1:
        raise ValueError(f"devices must be a non-empty list of one device "
                         f"type, got {[str(d) for d in devs]}")
    plan = torch.device(device)
    if plan.type != kinds[0]:
        raise ValueError(f"the planning device {plan} is not of the shards' "
                         f"type {kinds[0]}")
    check_device(kinds[0])
    if kinds[0] == "cuda":
        devs = [torch.device("cuda", 0 if d.index is None else d.index)
                for d in devs]
    return devs, (devs[0] if plan.index is None else plan)


class _Staged:
    """A device buffer fed from a pinned host twin (on a card): numpy writes
    the host side, and each upload is one asynchronous host-to-device copy
    of its first bytes, on its card's current stream, made together with
    the event that marks it landed in one call
    (:func:`staged_copy.upload`). :meth:`wait` holds the next write until
    the last copy has landed."""

    def __init__(self, nbytes: int, device: torch.device) -> None:
        cuda = device.type == "cuda"
        self.device = device
        with _on(device):
            self.host = torch.zeros((max(nbytes, 1),), dtype=torch.uint8,
                                    pin_memory=cuda)
            self.dev = torch.zeros((max(nbytes, 1),), dtype=torch.uint8,
                                   device=device)
            self._landed = torch.cuda.Event() if cuda else None
            if cuda:
                self._landed.record()  # created on this card
        self.np = self.host.numpy()

    def wait(self) -> None:
        if self._landed is not None:
            self._landed.synchronize()

    def upload(self, nbytes: int) -> None:
        if self._landed is None:
            self.dev[:nbytes].copy_(self.host[:nbytes])
            return
        with _on(self.device):
            _staged_copy.upload(self.dev, self.host, nbytes, self._landed)


class _Piece:
    """Rows [lo, lo + ns * Sl) of the resident task table, on one device:
    ``tab`` [rows, 2K+1] int32 (prios, types, then the row's rank), its
    views as [ns, Sl, ...] blocks (what the candidates read), the pinned
    staging of its changed rows and, on a card, the candidates' workspace.
    The solver keeps one piece of ``nshards`` logical shards, or one piece
    of one shard per entry of its ``devices``."""

    def __init__(self, lo: int, ns: int, Sl: int, K: int, T: int, D: int,
                 device: torch.device) -> None:
        self.lo, self.rows, self.K, self.device = lo, ns * Sl, K, device
        with _on(device):
            # every row free: priority floor, no type, rank 0 — free rows
            # are dead, so their gids can never surface as candidates
            tab = torch.zeros((self.rows, 2 * K + 1), dtype=torch.int32,
                              device=device)
            tab[:, :K] = _NEG
            tab[:, K:2 * K] = -1
        self.tab = tab
        self.blocks = (tab[:, :K].reshape(ns, Sl, K),
                       tab[:, K:2 * K].reshape(ns, Sl, K),
                       tab[:, 2 * K].reshape(ns, Sl))
        # a delta ships its changed rows (with their row index in the last
        # column) in one copy, then one index_copy_ on the device
        self.staged = _Staged(4 * self.rows * (2 * K + 2), device)
        n = self.rows * (2 * K + 2)
        self._np = self.staged.np.view(np.int32)[:n].reshape(self.rows,
                                                              2 * K + 2)
        self._dev = self.staged.dev.view(torch.int32)[:n].view(self.rows,
                                                               2 * K + 2)
        self.work = (_candidates.Workspace(ns, Sl, K, T, D, device)
                     if device.type == "cuda" else None)
        #: bytes a staged row takes: prios, types, rank, row index
        self.row_bytes = 4 * (2 * K + 2)
        #: uploads of changed rows so far (one per ingest that changed any)
        self.uploads = 0

    def upload(self, rows, tp, tt, rk) -> None:
        """Ship ``rows`` (indices within the piece) with their prios
        ``tp``, types ``tt`` and ranks ``rk``: one host-to-device copy of
        ``row_bytes`` a row, one ``index_copy_``; the rest of the piece
        stays where it is."""
        n, K = rows.size, self.K
        self.staged.wait()
        buf = self._np
        buf[:n, :K] = tp
        buf[:n, K:2 * K] = tt
        buf[:n, 2 * K] = rk
        buf[:n, 2 * K + 1] = rows
        self.staged.upload(n * self.row_bytes)
        staged = self._dev[:n]
        with _on(self.device):
            self.tab.index_copy_(0, staged[:, 2 * K + 1].long(),
                                 staged[:, :2 * K + 1])
        self.uploads += 1

    def candidates(self, T: int, D: int) -> torch.Tensor:
        """The piece's per-shard candidates as one [2, ns, T, D] int32
        tensor (prio, gid) on its device: one launch of the candidates
        kernel on its card, or the plain version on the CPU."""
        cp, cg = _candidates.shard_candidates(*self.blocks, T, D,
                                              work=self.work)
        return self.work.cands if self.work is not None else torch.stack(
            (cp, cg))


class _Requesters:
    """The device tier's requester side, resident on the planning device
    beside the task table: ``table`` [S * R, W] int32, one bitmask a
    requester row (bit t of word t // 32: the row is valid and accepts type
    t); the staged rows of the servers an ingest rewrote (``rows``: their
    slots, then the rows' type-mask bytes as the host mirror holds them,
    :func:`auction.delta_ints`), which the auction kernel's prologue packs
    into the table before it builds the windows; and ``order`` (the slots
    in use, then every slot in rank order), re-sent only when the
    membership changes. The mirror's mask is all False on a row that is
    not valid (``_pack_reqs``, ``_unregister`` and the ledger's packed rows
    write the two together; :meth:`stage` checks it), so a row's mask
    bytes are its accepting types, as ``_reqwin``'s ``req_mask &
    req_valid`` reads them."""

    def __init__(self, S: int, R: int, T: int, device: torch.device) -> None:
        self.S, self.R, self.T = S, R, T
        with _on(device):
            self.table = torch.zeros((S * R, (T + 31) // 32),
                                     dtype=torch.int32, device=device)
        self.rows = _Staged(4 * _auction.delta_ints(S, R, T), device)
        self.order = _Staged(4 * (S + 1), device)
        self._rows_np = self.rows.np.view(np.int32)
        #: slots whose staged rows the next plan applies
        self.pending = np.zeros((0,), dtype=np.int64)
        #: int32 tensors on the device: the staged rows, the rank order
        self.delta = self.rows.dev.view(torch.int32)
        self.order_dev = self.order.dev.view(torch.int32)

    def stage(self, slots, mask, valid) -> tuple:
        """Stage the rows of ``slots`` (with those still pending) from the
        host mirror's ``mask`` [S * R, T], whose rows are all False where
        ``valid`` [S * R] is (checked): one asynchronous copy. Returns (rows
        staged, bytes)."""
        R, T = self.R, self.T
        slots = np.asarray(slots, dtype=np.int64)
        if self.pending.size:
            slots = np.union1d(self.pending, slots)
        n = slots.size
        rows = mask.reshape(self.S, -1)[slots]
        # the mask bytes alone say which rows are valid
        bad = np.flatnonzero(~valid.reshape(self.S, R)[slots])
        assert not (bad.size and rows.reshape(n * R, T)[bad].any()), (
            "a requester row that is not valid accepts types")
        self.rows.wait()
        self._rows_np[:n] = slots
        self.rows.np[4 * n:4 * n + n * R * T] = rows.reshape(-1)
        nbytes = 4 * _auction.delta_ints(n, R, T)
        self.rows.upload(nbytes)
        self.pending = slots
        return n * R, nbytes

    def stage_order(self, slot_seq, nused: int) -> int:
        """Stage the rank order: ``nused`` slots in use, then ``slot_seq``.
        Returns the bytes."""
        self.order.wait()
        buf = self.order.np.view(np.int32)
        buf[0] = nused
        buf[1:1 + self.S] = slot_seq
        self.order.upload(4 * (self.S + 1))
        return 4 * (self.S + 1)


class DistributedAssignmentSolver:
    """Host wrapper mirroring AssignmentSolver.solve() but with the task
    table device-resident and cut into shards, updated incrementally from
    per-server snapshot deltas.

    ``devices`` places shard i's rows on ``devices[i]`` (``nshards`` is then
    ``len(devices)``; entries may repeat, all of one device type) and makes
    ``device`` the planning device, ``devices[0]`` unless it names a card:
    the merge, the auction and the requester tables live there. Without
    ``devices`` the ``nshards`` shards are logical, all on ``device``.

    Across devices the merge reads every piece's candidate lists where
    kernel A wrote them (``merge_route`` ``"in_place"``: peer access from
    the planning card to each other card, enabled when the solver is
    built), or, on a placement where the planning card cannot reach a
    piece's card by peer access, copies them to the planning device first
    (``"gather"``). The route is chosen when the solver is built (``None``,
    the default) or forced by ``merge_route``; a failed launch raises and
    never switches it. :meth:`warm` builds the pieces, the workspaces, the
    peer access and the events before the first plan (the engine calls it);
    otherwise the first ingest does.

    ``solve(snapshots, world)`` is the engine-compatible entry: it diffs
    the snapshots against the resident state (``ingest``) — a stamp fast
    path skips unchanged servers outright when snapshots carry
    ``task_stamp``/``stamp`` (the engine forwards them), falling back to
    a tuple compare otherwise — ships only changed rows to the device,
    runs the fixed-shape planning round (``plan``), and unpacks plan
    entries. Phase timings land in ``last_ingest_ms`` /
    ``last_solve_ms`` / ``last_extract_ms`` (read by the benchmark's round
    records and ``plan_bench``); the engine's obs gauges read
    ``last_sweep_ms``.

    ``tracer`` (a :class:`~adlb_tpu_torch.runtime.trace.Tracer`, or None
    for off) records each round's phases as spans on the tracer's clock:
    ``planner:ingest`` (children ``.diff``, ``.pack``, ``.upload``, and
    ``.reqrows`` on the device tier or ``.reqwin`` on the host tier) and
    ``planner:plan`` (children ``.enqueue``, ``.readback``, ``.extract``,
    or ``.host`` on the host tier), each with
    ``round`` (the plans made before it), ``parent`` and the phase's
    counts in its ``args``. It is a plain attribute: set it, or set it
    back to None, between rounds.

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
        devices: Optional[Sequence] = None,
        merge_route: Optional[str] = None,
        tracer=None,
    ) -> None:
        if auction not in ("device", "host"):
            raise ValueError(
                f"auction must be 'device' or 'host', got {auction!r}")
        if merge_route not in (None, "in_place", "gather"):
            raise ValueError(f"merge_route must be None, 'in_place' or "
                             f"'gather', got {merge_route!r}")
        if devices is not None:
            if nshards not in (1, len(devices)):
                raise ValueError(f"nshards={nshards} but {len(devices)} "
                                 f"devices: one shard per device")
            nshards = len(devices)
        if nshards < 1 or servers_per_shard < 1:
            raise ValueError("nshards and servers_per_shard must be >= 1")
        if cand_width < 1:
            raise ValueError(f"cand_width must be >= 1, got {cand_width}")
        if devices is None:
            self.devices = None
            self.device = check_device(device)
        else:
            self.devices, self.device = _placement(devices, device)
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

        # device state, allocated by warm() or at the first ingest
        # (constructing a solver touches no card): the resident table as
        # pieces (_Piece), one of all the logical shards or one per device;
        # with logical shards the piece's table [S, 2K+1], its [nshards, Sl,
        # ...] blocks and its staging are also _dev_tab, _dev_blocks and
        # _rows. Across devices (device tier): the pieces' runs, the merge
        # alone's workspace over them (on a card), on the gather route the
        # gathered [n, 2, T, D] lists on the planning device, and on the
        # in-place route across cards one event per other card (its runs
        # written) and one on the planning card (the runs read)
        self._pieces: Optional[list] = None
        self._dev_tab: Optional[torch.Tensor] = None
        self._dev_blocks: Optional[tuple] = None
        self._rows: Optional[_Staged] = None
        self._want_route = merge_route
        self.merge_route: Optional[str] = None
        self._gathered: Optional[torch.Tensor] = None
        self._merge_work: Optional[_candidates.MergeWorkspace] = None
        self._runs: Optional[list] = None
        self._runs_ready: dict = {}
        self._merged: Optional[torch.cuda.Event] = None
        #: runs this solver copied to the planning device (gather route)
        self.gather_copies = 0
        # device tier: the requester table resident on the planning device
        # (the auction kernel builds the windows from it), the slots whose
        # requester rows changed since the last ingest, and the last device
        # plan's windows as physical requester rows, [T, C + 1] (-1 past a
        # window, its length in column C; a type with no candidate has an
        # empty window)
        self._reqs: Optional[_Requesters] = None
        self._req_dirty_si: set = set()
        self._plan_rows: Optional[np.ndarray] = None
        #: the requester rows the last device plan's windows took in (up to
        #: the row that filled the last window of a type with a candidate,
        #: 0 when no type has one, or every row in use when such a window
        #: stays short)
        self.last_scanned: Optional[int] = None
        #: the auction rounds the last device plan ran, and the entries in
        #: them that lost their requester to another type's candidate
        self.last_rounds: Optional[int] = None
        self.last_lost: Optional[int] = None
        # the kernels' buffers on a card: the candidates (both tiers; one per
        # piece, _cand_work with logical shards) and the auction (device tier)
        self._cand_work: Optional[_candidates.Workspace] = None
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
        #: where the phases' spans go (None: not recorded)
        self.tracer = tracer
        # the last traced device plan's readings and counts, for its plan
        self._plan_readings = _NO_DEVICE_PLAN
        #: the last plan's committed gids per requester slot, [T, C] (-1 =
        #: none): what the tests and chip_smoke compare across placements
        self.last_assigned: Optional[np.ndarray] = None

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

    def warm(self) -> None:
        """Build the device state now: every piece on its device, the
        kernels' workspaces, peer access from the planning card to the
        others and the events (across cards, a CUDA context on every card
        of the placement). Idempotent; the first ingest calls it too."""
        self._ensure_built()

    def _ensure_built(self) -> None:
        if self._pieces is not None:
            return
        dev, K, T, C, D = self.device, self.K, self.T, self.C, self.D
        ns, Sl = self.nshards, self._Sl
        if dev.type == "cuda":
            # every source this solver loads, one nvcc each, all at once
            _cuda_build.build_all(
                [_candidates.SOURCE, _staged_copy.SOURCE]
                + ([_auction.SOURCE] if self.auction == "device" else []))
        if self.devices is None:
            piece = _Piece(0, ns, Sl, K, T, D, dev)
            self._pieces = [piece]
            self._dev_tab, self._dev_blocks = piece.tab, piece.blocks
            self._rows, self._cand_work = piece.staged, piece.work
        else:
            pieces = [_Piece(i * Sl, 1, Sl, K, T, D, d)
                      for i, d in enumerate(self.devices)]
            if self.auction == "device":
                self._build_merge(pieces)
            self._pieces = pieces
        if self.auction == "device":
            self._reqs = _Requesters(self.S, self.R, T, dev)
            if dev.type == "cuda":
                self._work = _auction.Workspace(T, C, self.m, dev)

    def _build_merge(self, pieces: list) -> None:
        """The merge across devices: its route (chosen here, once, unless
        forced), the runs it reads, its workspace on a card and, in place
        across cards, the events that order it against kernel A."""
        dev, T, D = self.device, self.T, self.D
        route = self._want_route or ("in_place" if all(
            d == dev or dev.type != "cuda"
            or torch.cuda.can_device_access_peer(dev.index, d.index)
            for d in self.devices) else "gather")
        if route == "gather":
            with _on(dev):
                self._gathered = torch.empty((len(pieces), 2, T, D),
                                             dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            # the pieces' runs stay where kernel A writes them
            self._runs = [p.work.cands[:, 0] for p in pieces]
            self._merge_work = _candidates.MergeWorkspace(
                list(self._gathered) if route == "gather" else self._runs,
                D, dev)
            others = sorted(set(self.devices) - {dev}, key=str)
            if route == "in_place" and others:
                self._runs_ready = {d: torch.cuda.Event() for d in others}
                self._merged = torch.cuda.Event()
        self.merge_route = route

    def _upload_rows(self, changed) -> tuple:
        """Ship the changed rows of the host mirror to the resident table:
        each row to the piece that owns it, one copy and one ``index_copy_``
        per piece with changed rows; the other pieces are not touched.
        Returns (rows shipped, pieces uploaded to)."""
        rows = np.unique(np.asarray(changed, dtype=np.int64))
        owner = rows // self._pieces[0].rows
        pieces = np.unique(owner).tolist()
        for i in pieces:
            piece, sel = self._pieces[i], rows[owner == i]
            piece.upload(sel - piece.lo, self._tp[sel], self._tt[sel],
                         np.maximum(self._row_rank[sel], 0))
        return rows.size, len(pieces)

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
            self._req_dirty_si.add(si)
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
        self._req_dirty_si.add(si)

    # ------------------------------------------------------------------
    def ingest(self, snapshots: dict) -> int:
        """Diff snapshots against the resident state; ship only changed
        server rows to the device. Returns changed-row count.

        Two passes: the diff walks every snapshot and collects the servers
        whose task or requester tuples changed (with the tuples), then the
        pack writes them into the host mirror in walk order (task rows and
        requester rows are separate state, so packing every server's tasks
        before the requesters changes nothing)."""
        t0 = clock()
        self._ensure_built()
        planned = self._planned_servers
        # (rank, tuples) of the servers whose tasks / requesters changed
        tfound: list = []
        rfound: list = []
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
                    tfound.append((s, tasks))
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
                    rfound.append((s, reqs))
                if rstamp is not None:
                    self._req_stamp[s] = rkey
        planned.clear()
        # servers that vanished (failover): unregistered below — their
        # rows cleared AND the slot freed for the next join. Checked every
        # ingest (O(S) dict lookups) — gating on a shrinking snapshot
        # COUNT missed a death that coincides with another server
        # joining, or a world larger than capacity S, leaving a dead
        # server's resident rows winning auctions forever
        vanished = [r for r in self._servers if r not in snapshots]
        t1 = clock()
        changed: list[int] = []
        for s, tasks in tfound:
            self._pack_tasks(s, tasks)
            changed.append(self._si[s])
        for s, reqs in rfound:
            self._pack_reqs(s, reqs)
        for s in vanished:
            self._unregister(s, changed)
        t2 = clock()
        fin = self._finish_ingest(changed)
        t3 = clock()
        self.last_ingest_ms = (t3 - t0) * 1e3
        tr = self.tracer
        if tr is not None:
            tr.defer(_ingest_spans, (
                self.solve_count, "tuple", t0, t1, t2, t3, len(snapshots),
                len(tfound), len(rfound),
                len({s for s, _ in tfound} | {s for s, _ in rfound}),
                len(vanished), len(changed), len(rfound),
                sum(len(r) for _, r in rfound)) + fin)
        return len(changed)

    def _finish_ingest(self, changed: list) -> Optional[tuple]:
        """Shared ingest tail (tuple and view paths): ship changed rows,
        patch or dirty the host tier's merged candidate lists; on the host
        tier rebuild the requester slot windows, on the device tier stage
        the changed requester rows (and the rank order after a membership
        change) for the auction kernel, which builds the windows. With a
        tracer, returns the end of the ingest's trace record: the upload's
        and the windows' or requester rows' readings and counts (Nones for
        a step that did not run)."""
        tr = self.tracer
        up, win = _NO_UPLOAD, _NO_REQWIN
        if changed:
            t0 = clock()
            rows, pieces = self._upload_rows(changed)
            if tr is not None:
                up = (t0, clock(), rows, rows * self._pieces[0].row_bytes,
                      pieces)
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
        if self.auction == "device":
            if self._req_dirty_si or self._row_perm is None:
                t0 = clock()
                rows = nbytes = 0
                order = self._row_perm is None
                if order:
                    slot_seq = self._rank_order()
                    nbytes = self._reqs.stage_order(slot_seq, len(self._si))
                if self._req_dirty_si:
                    rows, n = self._reqs.stage(sorted(self._req_dirty_si),
                                               self._req_mask,
                                               self._req_valid)
                    nbytes += n
                    self._req_dirty_si.clear()
                self._reqs_dirty = False
                if tr is not None:
                    win = (t0, clock(), rows, nbytes, order)
        elif self._reqs_dirty:
            t0 = clock()
            perm_rebuilt = self._row_perm is None
            if perm_rebuilt:
                self._rank_order()
            self._rw, self._lens = _reqwin(
                self._req_mask, self._req_valid, self.T, self.C,
                self._row_perm)
            self._reqs_dirty = False
            self._req_dirty_si.clear()
            if tr is not None:
                win = (t0, clock(), None, 0, perm_rebuilt)
        return None if tr is None else up + win

    def _rank_order(self) -> np.ndarray:
        """The server slots in rank order, then the unused slots (all their
        rows invalid — order among them is irrelevant); sets ``_row_perm``,
        the requester rows in that order (see :func:`_reqwin`)."""
        used = sorted(self._si.items())  # (rank, si) rank-asc
        rest = sorted(set(range(self.S)) - {si for _, si in used})
        slot_seq = np.asarray([si for _, si in used] + rest, dtype=np.int64)
        self._row_perm = (
            slot_seq[:, None] * self.R
            + np.arange(self.R, dtype=np.int64)[None, :]).reshape(-1)
        return slot_seq

    def host_windows(self) -> tuple:
        """The requester windows as the host builds them from its mirror
        (:func:`_reqwin` in rank order): (reqwin [T, C] physical rows,
        lens [T]). The host tier plans over them; on the device tier they
        are what the auction kernel's prologue builds for the types with a
        candidate, the others' windows left empty."""
        if self._row_perm is None:
            self._rank_order()
        return _reqwin(self._req_mask, self._req_valid, self.T, self.C,
                       self._row_perm)

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
        t0 = clock()
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
        tslots = np.flatnonzero(view.t_gen != self._seen_tgen).tolist()
        rslots = np.flatnonzero(view.r_gen != self._seen_rgen).tolist()
        t1 = clock()
        R = self.R
        slot_rank = view.slot_rank
        for slot in tslots:
            self._seen_tgen[slot] = view.t_gen[slot]
            si = self._si.get(int(slot_rank[slot]))
            if si is None:
                continue  # freed slot, or beyond-capacity extra
            self._tp[si, :] = view.pk_tp[slot]
            self._tt[si, :] = view.pk_tt[slot]
            self._task_ref[si] = list(view.pk_trefs[slot])
            changed.append(si)
        rpacked: list = []
        for slot in rslots:
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
            self._req_dirty_si.add(si)
            rpacked.append(slot)
        # plan() keeps recording its touches for the tuple path; the
        # view path's generations already carry them — drop so the set
        # cannot grow unboundedly
        self._planned_servers.clear()
        t2 = clock()
        fin = self._finish_ingest(changed)
        t3 = clock()
        self.last_ingest_ms = (t3 - t0) * 1e3
        tr = self.tracer
        if tr is not None:
            tr.defer(_ingest_spans, (
                self.solve_count, "view", t0, t1, t2, t3, len(view.servers),
                len(tslots), len(rslots), len(set(tslots) | set(rslots)),
                None, len(changed), len(rpacked),
                int(view.pk_rv[rpacked].sum())) + fin)
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
        devices plus the device->host transfer of the planning round (one
        per piece), re-materializing the merged candidate lists."""
        t0 = clock()
        both = np.concatenate(
            [p.candidates(self.T, self.D).cpu().numpy()
             for p in self._pieces], axis=1)
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
        self.last_sweep_ms = (clock() - t0) * 1e3

    def _wait_runs(self) -> None:
        """In place across cards: each other card's stream marks its runs
        written (kernel A enqueued before), and the planning card's stream
        waits for every mark before the merge reads them. Same-card pieces
        share the planning stream and need none."""
        if not self._runs_ready:
            return
        plan_stream = torch.cuda.current_stream(self.device)
        for d, ev in self._runs_ready.items():
            with _on(d):
                ev.record()
            plan_stream.wait_event(ev)

    def _enqueue_device_plan(self) -> torch.Tensor:
        """The device-tier planning round (the plain versions on the CPU),
        enqueued, not read back: the assignment [T, C+1] on the planning
        device. With logical shards: one candidates launch (every shard's
        candidates and their merge, cut to [T, D]) and one auction launch.
        Across devices: one candidates launch on each device over its shard,
        one launch of the merge alone and one auction launch on the planning
        device. In place across cards the merge reads the runs over peer
        access after :meth:`_wait_runs`, and each other card's next kernel A
        waits for the merge's read (``_merged``): the pieces' runs are
        overwritten by the next plan, which no readback may order. The
        gather route copies the runs first (PyTorch orders a copy after its
        source's stream and the planning stream after the copy)."""
        if self.devices is None:
            gp, gg = _candidates.merged_candidates(
                *self._dev_blocks, self.T, self.D, work=self._cand_work)
        else:
            for d in self._runs_ready:
                torch.cuda.current_stream(d).wait_event(self._merged)
            cands = [p.candidates(self.T, self.D) for p in self._pieces]
            runs = self._runs or [c[:, 0] for c in cands]
            if self._gathered is not None:
                runs = _candidates.gather_runs(runs, self._gathered)
                self.gather_copies += len(runs)
            self._wait_runs()
            gp, gg = _candidates.merge_runs(runs, self.D,
                                            work=self._merge_work)
            if self._merged is not None:
                with _on(self.device):
                    self._merged.record()
        rq = self._reqs
        out = _auction.auction_windows(
            gp, gg, rq.table, rq.order_dev, rq.delta, rq.pending.size,
            self.rounds, self.m, self.C, work=self._work)
        rq.pending = rq.pending[:0]
        return out

    def _device_plan(self) -> np.ndarray:
        """:meth:`_enqueue_device_plan`, then one readback of its output:
        the host blocked until the device's work and the copy have landed.
        Returns the committed gids [T, C]; keeps each slot's requester row
        for the extraction (the windows of the types with a candidate; the
        others are empty, as the kernel's scan stops once every such window
        holds C rows) and the counts that follow the rows: the auction
        rounds run, ``scanned`` and the entries lost to another type."""
        tr = self.tracer
        if tr is not None:
            launches = (_candidates.launches + _candidates.merge_launches
                        + _auction.launches)
        t0 = clock()
        out = self._enqueue_device_plan()
        t1 = clock()
        flat = out.cpu().numpy()
        T, C = self.T, self.C
        n = T * (C + 1)
        self._plan_rows = flat[n:2 * n].reshape(T, C + 1)
        self.last_rounds, self.last_scanned, self.last_lost = (
            int(x) for x in flat[2 * n:2 * n + 3])
        if tr is not None:
            self._plan_readings = (
                t0, t1, clock(), _candidates.launches
                + _candidates.merge_launches + _auction.launches - launches,
                flat.nbytes, self.last_scanned, self.last_rounds,
                self.last_lost)
        return flat[:n].reshape(T, C + 1)[:, :C]

    def plan(self) -> list:
        """One fixed-shape planning round over the resident state."""
        if not self._req_valid.any():
            return []
        t0 = clock()
        self._ensure_built()
        tr = self.tracer
        swept = None
        if self.auction == "device":
            assigned = self._device_plan()
        else:
            swept = False
            if (
                self._cand_dirty
                or self._plans_since_sweep >= self.RESYNC_INTERVAL
            ):
                self.sweep_reasons[
                    "cold" if self._gp is None
                    else "delta" if self._cand_dirty
                    else "cadence"] += 1
                self._sweep()
                swept = True
            self._plans_since_sweep += 1
            req_open = self._req_valid.copy()
            assigned = _host_auction(
                self._gp, self._gg, self._rw, self._lens, req_open,
                self.rounds, self.m)
        t1 = clock()
        self.last_solve_ms = (t1 - t0) * 1e3
        self.last_assigned = assigned
        pairs = []
        t_idx, c_idx = np.nonzero(assigned >= 0)
        gids = assigned[t_idx, c_idx].tolist()
        rids = (self._rw if swept is not None
                else self._plan_rows)[t_idx, c_idx].tolist()
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
        t2 = clock()
        self.last_extract_ms = (t2 - t1) * 1e3
        if tr is not None:
            tr.defer(_plan_spans, (
                self.solve_count, t0, t1, t2, len(pairs), swept)
                + (self._plan_readings if swept is None
                   else _NO_DEVICE_PLAN))
        self.solve_count += 1
        return pairs

    def planner_counts(self) -> dict:
        """This solver's own counts, in the keys of the single-device
        solver's ``planner_counts`` (it makes no greedy-sweep solves, so
        those are 0) plus its plans (``device_plans``: device tier, each
        with its requester windows built by the auction, so
        ``device_windows`` is the same count; ``host_plans``: host tier),
        the merge's route across devices
        (``merge_route``: ``"in_place"``, ``"gather"``, or None with logical
        shards or before it is built) and the runs it copied to the planning
        device (``gather_copies``)."""
        device = self.auction == "device"
        return {"device_solves": 0, "host_solves": 0,
                "greedy_sweep_launches": 0, "solves_kept": 0,
                "solves_checked": 0, "solves_wrong": 0, "device_shapes": [],
                "device_plans": self.solve_count if device else 0,
                "host_plans": 0 if device else self.solve_count,
                "device_windows": self.solve_count if device else 0,
                "merge_route": self.merge_route,
                "gather_copies": self.gather_copies}

    def solve(self, snapshots, world) -> list:
        """Engine-compatible one-call path: ingest deltas, then plan.
        Accepts either the filtered-snapshot dict or the engine's
        array-resident ledger view."""
        if getattr(snapshots, "is_array", False):
            self._ingest_view(snapshots)
        else:
            self.ingest(snapshots)
        return self.plan()
