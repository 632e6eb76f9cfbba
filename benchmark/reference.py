"""The plain NumPy reference that decides ``correct``.

Imports numpy alone: nothing of the program (``adlb_tpu_torch``), of the JAX
package or of JAX. Each function works its answer out again from what the
harness itself handed the program.

:func:`plan_from_snapshots` is the sharded planner's round. From the
per-server snapshots it packs its own task table (gid = rank * K + ki,
priorities clipped), its own requester windows (the first C open requesters
of each type, servers in rank order), each type's candidates in (priority
desc, gid asc) order, and runs the auction rounds: the host tier's
algorithm (``distributed._host_auction``) written again here, which the
planner's design says its device tier equals exactly. It returns the pairs
and the [T, C] assignment.

``prio_shift`` > 0 computes it with the priorities coarsened to
``prio >> prio_shift``: the control, which breaks the configuration's
guarantee of strict priority order and must come out not correct.
"""

from __future__ import annotations

import numpy as np

NEG = -(2**31) + 1
I32MAX = 2**31 - 1
PRIO_CLIP = 10**9


def slot_sizes(cand_width: int, rounds: int, nreq_rows: int):
    """(C, D): requester slots a type and the candidate depth, as the
    planner's configuration fixes them: C = max(64, m * rounds) cut to the
    requester rows, D = C + m + 1."""
    C = min(max(64, cand_width * max(rounds, 1)), nreq_rows) or 1
    return C, C + cand_width + 1


def _clip(p: int) -> int:
    return max(-PRIO_CLIP, min(PRIO_CLIP, p))


def pack_snapshots(snaps: dict, types, K: int, R: int, C: int,
                   prio_shift: int = 0):
    """The planner's inputs from the snapshots, worked out again.

    Returns (cands, reqwin, lens, req_refs, task_refs): ``cands[t]`` the
    (prio, gid) of every live task of type index t in (prio desc, gid asc)
    order; ``reqwin [T, C]`` the first C requester rows accepting each type
    (rows numbered in scan order: servers by rank, then list order), -1
    padded; ``req_refs[row] = (home, for_rank, rqseqno)``; ``task_refs[gid]
    = (holder, seqno)``."""
    tindex = {t: i for i, t in enumerate(types)}
    T = len(types)
    per_type: list = [[] for _ in range(T)]
    task_refs: dict = {}
    for s in sorted(snaps):
        for ki, tk in enumerate(snaps[s]["tasks"][:K]):
            ti = tindex.get(tk[1], -1)
            if ti < 0:
                continue
            gid = s * K + ki
            p = _clip(tk[2]) >> prio_shift
            per_type[ti].append((-p, gid))
            task_refs[gid] = (s, tk[0])
    cands = []
    for lst in per_type:
        lst.sort()
        cands.append([(-np_, g) for np_, g in lst])
    reqwin = np.full((T, C), -1, dtype=np.int64)
    lens = np.zeros((T,), dtype=np.int64)
    req_refs: list = []
    full = 0
    for s in sorted(snaps):
        if full == T:
            break
        for req in snaps[s]["reqs"][:R]:
            row = len(req_refs)
            req_refs.append((s, req[0], req[1]))
            want = range(T) if req[2] is None else [
                tindex[t] for t in req[2] if t in tindex]
            for ti in want:
                n = lens[ti]
                if n < C:
                    reqwin[ti, n] = row
                    lens[ti] = n + 1
                    full += lens[ti] == C
    return cands, reqwin, lens, req_refs, task_refs


def auction(cands, reqwin, lens, rounds: int, m: int, D: int):
    """The auction rounds over per-type candidate lists cut to depth D:
    rank-k candidates pair with the k-th open slot of their type, a
    requester claimed by several types goes to the best (prio, -gid), a
    global threshold (the best loser, and each type's (m+1)-th candidate
    while it has an open slot) holds back any winner a displaced
    candidate could cascade into, and commits are prefixes. Stops at the
    first round that commits nothing. Returns assigned [T, C] of gids."""
    T, C = reqwin.shape
    L = D
    gp = np.full((T, L), NEG, dtype=np.int64)
    gg = np.full((T, L), I32MAX, dtype=np.int64)
    for t, lst in enumerate(cands):
        n = min(len(lst), L)
        if n:
            arr = np.asarray(lst[:n], dtype=np.int64)
            gp[t, :n], gg[t, :n] = arr[:, 0], arr[:, 1]
    nrows = int(reqwin.max()) + 1 if reqwin.size and reqwin.max() >= 0 else 0
    req_open = np.ones((max(nrows, 1),), dtype=bool)
    head = np.zeros((T,), dtype=np.int64)
    nlive = (gp > NEG).sum(axis=1)
    slot_valid = np.arange(C)[None, :] < lens[:, None]
    assigned = np.full((T, C), -1, dtype=np.int64)
    for _ in range(rounds):
        entries = []  # (t, j, prio, gid, slot, row) of the valid pairs
        trunc = {}
        for t in range(T):
            open_slots = np.flatnonzero(
                slot_valid[t] & req_open[np.clip(reqwin[t], 0, None)])
            if open_slots.size == 0:
                continue
            h = int(head[t])
            if h + m < nlive[t]:
                trunc[t] = (int(gp[t, h + m]), -int(gg[t, h + m]))
            for j in range(min(m, open_slots.size, int(nlive[t]) - h)):
                c = int(open_slots[j])
                entries.append((t, j, int(gp[t, h + j]), int(gg[t, h + j]),
                                c, int(reqwin[t, c])))
        best: dict = {}
        for e in entries:
            key = (e[2], -e[3])
            if e[5] not in best or key > best[e[5]][0]:
                best[e[5]] = (key, e)
        winners = {(e[0], e[1]) for _, e in best.values()}
        threshold = (NEG, -I32MAX)
        for e in entries:
            if (e[0], e[1]) not in winners:
                threshold = max(threshold, (e[2], -e[3]))
        for key in trunc.values():
            threshold = max(threshold, key)
        commits = 0
        for t in range(T):
            for e in (x for x in entries if x[0] == t):
                if (e[0], e[1]) not in winners:
                    break
                if (e[2], -e[3]) <= threshold:
                    continue
                assigned[t, e[4]] = e[3]
                req_open[e[5]] = False
                head[t] += 1
                commits += 1
        if commits == 0:
            break
    return assigned


def plan_from_snapshots(snaps: dict, types, K: int, R: int, nservers: int,
                        rounds: int, m: int, prio_shift: int = 0):
    """One planning round worked out from the snapshots: (pairs, assigned).
    ``pairs`` are (holder, seqno, req_home, for_rank, rqseqno) in the
    planner's order: by type, then by requester slot."""
    C, D = slot_sizes(m, rounds, nservers * R)
    cands, reqwin, lens, req_refs, task_refs = pack_snapshots(
        snaps, types, K, R, C, prio_shift)
    if not req_refs:
        return [], None
    assigned = auction(cands, reqwin, lens, rounds, m, D)
    pairs = []
    for t, c in zip(*np.nonzero(assigned >= 0)):
        holder, seqno = task_refs[int(assigned[t, c])]
        home, for_rank, rqseqno = req_refs[int(reqwin[t, c])]
        pairs.append((holder, seqno, home, for_rank, rqseqno))
    return pairs, assigned
