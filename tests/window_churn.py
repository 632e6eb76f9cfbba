"""A churn of parked requesters for the sharded planner's requester windows,
shared by the CPU tests (``test_torch_device_plan.py``) and the card's
(``test_torch_cuda.py``, which imports neither JAX nor the ``tests``
package: this module is imported by its name, from the tests directory).

``WindowChurn`` keeps snapshots of ``nservers`` servers as the engine hands
them to ``DistributedAssignmentSolver.solve``: tasks in bursts, requesters
that re-park once their plan is consumed, and every fifth round a server
leaving and a new rank joining (the rank order changes, so the device tier
re-sends it). Its cases:

- ``mixed``: single types, multi-type lists and any-type requesters
  (``types=None``); every window fills, so the scan stops early;
- ``rare``: one type that at most a few requesters accept, so its window
  stays short and the scan reaches the end of the rows in use;
- ``multi_job``: two jobs, so composite (job, type) types, any-type
  requesters filling their job's block of windows;
- ``drain``: every requester consumed and none re-parked for a few rounds
  (an empty requester table), then the world parks again.

:func:`check_windows` holds a device-tier solver's last windows to the
host's ``_reqwin`` over its own mirror (:func:`assert_windows`: the windows
of the live types, those with a candidate, equal, the others a prefix, as
the device tier builds the live windows alone); :func:`random_windows`
makes the inputs of ``auction.auction_windows`` alone.
"""

import numpy as np

TYPES = (1, 2, 3, 4)
CASES = ("mixed", "rare", "multi_job", "drain")
NEG = -(2**31) + 1  # the padding priority


class WindowChurn:
    def __init__(self, seed: int, case: str, nservers: int = 20, R: int = 6,
                 K: int = 8) -> None:
        assert case in CASES
        self.rng = np.random.default_rng(seed)
        self.case, self.R, self.K = case, R, K
        self.J = 2 if case == "multi_job" else 1
        self.clock = 1.0
        self.seq = self.rq = self.rnd = 0
        self.draining = False
        self.next_rank = 100 + nservers
        self.snaps = {100 + s: self._fresh(100 + s) for s in range(nservers)}

    def _tick(self) -> float:
        self.clock += 1.0
        return self.clock

    def _task(self) -> tuple:
        self.seq += 1
        tk = (self.seq, int(self.rng.choice(TYPES)),
              int(self.rng.integers(-20, 20)), 8)
        return tk + (int(self.rng.integers(0, 2)),) if self.J > 1 else tk

    def _req(self, rank: int, i: int) -> tuple:
        self.rq += 1
        u = self.rng.random()
        if self.case == "rare":
            # type 4 only for the first requester of ranks divisible by 7
            types = ([4] if i == 0 and rank % 7 == 0
                     else [int(self.rng.choice(TYPES[:3]))])
        elif u < 0.2:
            types = None
        elif u < 0.4:
            types = sorted({int(t) for t in self.rng.choice(TYPES, 2)})
        else:
            types = [int(self.rng.choice(TYPES))]
        rq = (rank * 10 + i, self.rq, types)
        return rq + (0, int(self.rng.integers(0, 2))) if self.J > 1 else rq

    def _fresh(self, rank: int) -> dict:
        st = self._tick()
        tasks = sorted((self._task() for _ in range(int(
            self.rng.integers(0, 5)))), key=lambda t: -t[2])
        reqs = [] if self.draining else [self._req(rank, i) for i in range(
            int(self.rng.integers(self.R // 2, self.R + 1)))]
        return {"tasks": tasks, "reqs": reqs, "stamp": st, "task_stamp": st}

    def step(self, pairs: list) -> dict:
        """Consume ``pairs`` (the matched requesters re-park, unless the
        world is draining), burst tasks into three servers, and every fifth
        round let one server leave and a new rank join. Returns the
        snapshots of the next round."""
        self.rnd += 1
        st = self._tick()
        draining = self.draining = self.case == "drain" and 3 <= self.rnd < 8
        for holder, seqno, home, for_rank, rqseqno in pairs:
            h, q = self.snaps.get(holder), self.snaps.get(home)
            if h is not None:
                h["tasks"] = [t for t in h["tasks"] if t[0] != seqno]
                h["task_stamp"] = st
            if q is not None:
                q["reqs"] = [r for r in q["reqs"]
                             if (r[0], r[1]) != (for_rank, rqseqno)]
                if not draining:
                    q["reqs"].append(self._req(home, len(q["reqs"])))
                q["stamp"] = st
        if draining:
            for snap in self.snaps.values():
                if snap["reqs"]:
                    snap["reqs"] = []
                    snap["stamp"] = st
        elif self.case == "drain" and self.rnd == 8:
            for rank, snap in self.snaps.items():
                snap["reqs"] = [self._req(rank, i) for i in range(self.R)]
                snap["stamp"] = st
        ranks = sorted(self.snaps)
        for s in self.rng.choice(ranks, 3, replace=False).tolist():
            snap = self.snaps[s]
            snap["tasks"] = sorted(snap["tasks"] + [self._task()
                                                    for _ in range(4)],
                                   key=lambda t: -t[2])[:self.K]
            snap["task_stamp"] = st
        if self.rnd % 5 == 0:
            del self.snaps[ranks[int(self.rng.integers(0, len(ranks)))]]
            self.snaps[self.next_rank] = self._fresh(self.next_rank)
            self.next_rank += 1
        return self.snaps


def solver_kwargs(case: str, nshards: int) -> dict:
    """A solver for :class:`WindowChurn`'s world: room for its joins, C = 8
    slots a type over about 100 requester rows."""
    kw = dict(types=TYPES, max_tasks_per_server=8, max_requesters=6,
              nshards=nshards, servers_per_shard=-(-24 // nshards), rounds=8,
              cand_width=4, slots_per_type=8)
    if case == "multi_job":
        kw.update(max_jobs=2, job_weights={1: 2.0})
    return kw


def reach(vm, C: int, live) -> int:
    """The rows a scan in order over ``vm`` [n, T] (each row's accepting
    types) takes in for the ``live`` types' windows of C: up to the row
    that fills the last live window, 0 when no type is live, or every row
    when a live window stays short."""
    n = vm.shape[0]
    live = np.flatnonzero(live)
    if not live.size:
        return 0
    cs = np.cumsum(vm, axis=0)
    if not n or (cs[-1, live] < C).any():
        return n
    return max(int(np.argmax(cs[:, t] >= C)) + 1 for t in live)


def live_types(sol) -> np.ndarray:
    """[T] bool from a solver's host mirror: the types with a candidate in
    its resident task table (a slot with a priority and a type), those
    whose windows the device plan builds."""
    live = np.zeros((sol.T,), dtype=bool)
    live[sol._tt[(sol._tp > NEG) & (sol._tt >= 0)]] = True
    return live


def host_reach(sol) -> int:
    """The rows the device plan's windows take in, from the host mirror:
    :func:`reach` over the rows of the servers in use, in rank order, for
    the types with a candidate."""
    sol.host_windows()
    n = len(sol._si) * sol.R
    order = sol._row_perm[:n]
    vm = sol._req_mask[order] & sol._req_valid[order, None]
    return reach(vm, sol.C, live_types(sol))


def assert_windows(rows, rw, lens, live) -> None:
    """Windows as the device tier gives them (``rows`` [T, C + 1]: each
    slot's physical row, -1 past the window, its length in column C)
    against the host's ``_reqwin`` (``rw`` [T, C], ``lens``): each live
    type's window equal, each other type's a prefix of the host's."""
    rows = np.asarray(rows)
    T, C = rw.shape
    assert rows.shape == (T, C + 1)
    for t in range(T):
        n = int(rows[t, C])
        if live[t]:
            assert n == lens[t], t
            np.testing.assert_array_equal(rows[t, :C], rw[t])
        else:
            assert 0 <= n <= lens[t], t
            np.testing.assert_array_equal(rows[t, :n], rw[t, :n])
            assert (rows[t, n:C] == -1).all(), t


def check_windows(sol) -> None:
    """The device tier's last windows (physical rows, lengths, ``scanned``)
    against the host's ``_reqwin`` over the solver's own mirror
    (:func:`assert_windows`)."""
    rw, lens = sol.host_windows()
    assert_windows(sol._plan_rows, rw, lens, live_types(sol))
    assert sol.last_scanned == host_reach(sol)


def _words(mask, valid, T: int):
    """Requester rows as the resident table holds them: bit t of word
    t // 32 set when the row is valid and accepts type t."""
    W = (T + 31) // 32
    vm = (mask & valid[:, None]).astype(np.uint64)
    out = np.zeros((mask.shape[0], W), dtype=np.uint64)
    for t in range(T):
        out[:, t // 32] |= vm[:, t] << np.uint64(t % 32)
    return out.astype(np.uint32).view(np.int32)


def staged_rows(slots, mask, valid) -> np.ndarray:
    """The staged rows of ``slots`` as ``auction.delta_ints`` lays them out
    (the slots, then the rows' type-flag bytes padded to a word), from
    their rows' ``mask`` [n * R, T] and ``valid``."""
    flags = (np.asarray(mask) & np.asarray(valid)[:, None]).astype(
        np.uint8).reshape(-1)
    flags = np.concatenate([flags, np.zeros(-flags.size % 4, np.uint8)])
    return np.concatenate([np.asarray(slots, np.int32), flags.view(np.int32)])


def random_windows(rng, T: int, C: int, R: int, density: float,
                   n_delta: int, S: int = 30, nused: int = 25, m: int = 3,
                   rounds: int = 6) -> dict:
    """Inputs of ``auction.auction_windows`` as numpy arrays: a requester
    table of S slots x R rows (the unused slots' rows invalid) whose
    ``n_delta`` staged slots hold stale rows until the delta is applied,
    the rank order, merged candidate lists [T, C + m + 1] (priorities
    descending, gids unique and ascending along each list); with the host
    mirror (``mask``, ``valid``, the row order ``perm``), the table the
    launch must leave and the ``scanned`` it must report."""
    NR = S * R
    mask = rng.random((NR, T)) < density
    valid = rng.random(NR) < 0.9
    seq = rng.permutation(S).astype(np.int64)
    rest = seq[nused:]
    valid[(rest[:, None] * R + np.arange(R)).reshape(-1)] = False
    dslots = np.sort(rng.choice(seq[:nused], n_delta, replace=False))
    drows = (dslots[:, None] * R + np.arange(R)).reshape(-1)
    want = _words(mask, valid, T)
    table = want.copy()
    table[drows] = _words(rng.random((drows.size, T)) < 0.5,
                          np.ones(drows.size, bool), T)
    delta = staged_rows(dslots, mask[drows], valid[drows])
    perm = (seq[:, None] * R + np.arange(R)).reshape(-1)
    vm = (mask & valid[:, None])[perm[:nused * R]]
    L = C + m + 1
    gp = np.ascontiguousarray(np.sort(rng.integers(-9, 9, (T, L)),
                                      axis=1)[:, ::-1]).astype(np.int32)
    gg = (np.arange(T * L).reshape(T, L) * 7 + 1).astype(np.int32)
    return dict(gp=gp, gg=gg, table=table,
                order=np.concatenate([[nused], seq]).astype(np.int32),
                delta=delta, mask=mask, valid=valid, perm=perm, nused=nused,
                want_table=want, reach=reach(vm, C, np.ones(T, bool)), m=m,
                rounds=rounds)

