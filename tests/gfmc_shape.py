"""GFMC's request shape (upstream's GFMC model, ``examples/gfmc_c.c``) at a
test's size, for the sharded planner's tests on the CPU
(``test_torch_gfmc_plan.py``) and on the card (``test_torch_cuda.py``, which
imports neither JAX nor the ``tests`` package: this module is imported by
its name, from the tests directory).

Five types, A, B, C, C_ANSWER and D (1-5). Every worker parks on [A, B, C,
C_ANSWER], the master, the first requester row of the first server, on
[D]. Only untargeted work reaches the planner: tasks of A, B and C at the
fixed priorities 1, 2 and 3, so every requester sits in four windows and C
beats B beats A on every shared row. C_ANSWER and D work is targeted and
never queued for the planner, so those two types have no candidate and
their windows are not needed: D's, with one accepting row, never fills.
The ``d_task`` cases break that on purpose: a D task queued, so D is live
and its window stays short.

:class:`GfmcWorld` keeps snapshots as the engine hands them to
``DistributedAssignmentSolver.solve``; :func:`gfmc_windows` makes the inputs
of ``auction.auction_windows`` alone.
"""

import numpy as np

TYPES = (1, 2, 3, 4, 5)
WORKER = [1, 2, 3, 4]
MASTER = [5]
PRIO = {1: 1, 2: 2, 3: 3, 5: 9}
#: tasks of A, B and C a round: the economy's 1 : 4 : 12 (each A puts 4 B,
#: each B puts 3 C)
MIX = {1: 1, 2: 4, 3: 12}


class GfmcWorld:
    """``nservers`` servers (ranks 100 up), each home to R parked
    requesters (ranks s * R + i; rank 0, the master, on [D]). Each round the
    matched tasks leave and the matched requesters re-park on their vector
    at the end of their home's list, then a burst of MIX's tasks in a seeded
    order lands on ``per_round`` servers in turn (``d_task``: and one D task
    on the next one), each server keeping its K highest."""

    def __init__(self, seed: int, nservers: int = 40, R: int = 12,
                 K: int = 8, per_round: int = 3, d_task: bool = False):
        self.rng = np.random.default_rng(seed)
        self.S, self.R, self.K = nservers, R, K
        self.per_round, self.d_task = per_round, d_task
        self.clock = 1.0
        self.seq = self.rq = self.rnd = 0
        self.snaps = {}
        for s in range(nservers):
            reqs = []
            for i in range(R):
                self.rq += 1
                vec = MASTER if s == 0 and i == 0 else WORKER
                reqs.append((s * R + i, self.rq, vec))
            self.snaps[100 + s] = {"tasks": [], "reqs": reqs,
                                   "stamp": self.clock,
                                   "task_stamp": self.clock}
        self.land()

    def land(self) -> None:
        """This round's burst."""
        self.clock += 1.0
        types = [t for t, n in MIX.items() for _ in range(n)]
        types = self.rng.permutation(types).tolist()
        if self.d_task:
            types.append(5)
        n = len(types)
        per = -(-n // self.per_round)
        for k in range(0, n, per):
            s = 100 + (self.rnd * self.per_round + k // per) % self.S
            snap = self.snaps[s]
            new = []
            for t in types[k:k + per]:
                self.seq += 1
                new.append((self.seq, t, PRIO[t], 8))
            snap["tasks"] = sorted(snap["tasks"] + new,
                                   key=lambda tk: -tk[2])[:self.K]
            snap["task_stamp"] = self.clock
        self.rnd += 1

    def step(self, pairs: list) -> dict:
        """Consume ``pairs``, then land the next burst. Returns the
        snapshots of the next round."""
        self.clock += 1.0
        for holder, seqno, home, for_rank, rqseqno in pairs:
            h, q = self.snaps[holder], self.snaps[home]
            h["tasks"] = [t for t in h["tasks"] if t[0] != seqno]
            h["task_stamp"] = self.clock
            vec = next(r[2] for r in q["reqs"]
                       if (r[0], r[1]) == (for_rank, rqseqno))
            self.rq += 1
            q["reqs"] = [r for r in q["reqs"]
                         if (r[0], r[1]) != (for_rank, rqseqno)]
            q["reqs"].append((for_rank, self.rq, vec))
            q["stamp"] = self.clock
        self.land()
        return self.snaps


def solver_kwargs(nshards: int, nservers: int = 40, R: int = 12,
                  K: int = 8) -> dict:
    """A solver for :class:`GfmcWorld`: m = 4 commits a type a round, 8
    rounds, so C = 64 slots a type over nservers * R rows."""
    return dict(types=TYPES, max_tasks_per_server=K, max_requesters=R,
                nshards=nshards, servers_per_shard=-(-nservers // nshards),
                rounds=8, cand_width=4)


def gfmc_windows(rng, S: int, nused: int, R: int, C: int, m: int,
                 rounds: int, tasks: dict, n_delta: int = 0) -> dict:
    """Inputs of ``auction.auction_windows`` (numpy arrays) on GFMC's shape:
    a requester table of S slots x R rows, the first ``nused`` slots in use
    in a seeded rank order, every row on [A, B, C, C_ANSWER] but the first
    row of the first slot in rank order, on [D]; ``n_delta`` of the slots
    in use staged (their rows in the table stale until the delta is
    applied). Merged candidate lists [5, C + m + 1]: ``tasks[t]`` tasks of
    type t at PRIO[t], unique gids ascending along each list. Returns them
    with ``want_table``, the table the launch must leave, and ``mask``,
    ``valid``, ``perm`` for the host's ``_reqwin``."""
    T, NR = len(TYPES), S * R
    seq = rng.permutation(S).astype(np.int64)
    perm = (seq[:, None] * R + np.arange(R)).reshape(-1)
    valid = np.zeros(NR, dtype=bool)
    valid[perm[:nused * R]] = True
    mask = np.zeros((NR, T), dtype=bool)
    mask[valid, :4] = True
    mask[perm[0]] = [False] * 4 + [True]
    # one mask word a row: bit t for type index t
    want = (mask.astype(np.int32) << np.arange(T, dtype=np.int32)).sum(
        axis=1, dtype=np.int32).reshape(NR, 1)
    table = want.copy()
    dslots = np.sort(rng.choice(seq[:nused], n_delta, replace=False))
    drows = (dslots[:, None] * R + np.arange(R)).reshape(-1)
    table[drows] = 0
    flags = mask[drows].astype(np.uint8).reshape(-1)
    flags = np.concatenate([flags, np.zeros(-flags.size % 4, np.uint8)])
    delta = np.concatenate([dslots.astype(np.int32), flags.view(np.int32)])
    L = C + m + 1
    gp = np.full((T, L), -(2**31) + 1, dtype=np.int32)
    gg = np.full((T, L), 2**31 - 1, dtype=np.int32)
    gid = 0
    for t, n in tasks.items():
        gp[t - 1, :n] = PRIO[t]
        gg[t - 1, :n] = np.arange(gid, gid + n) * 3 + 1
        gid += n
    return dict(gp=gp, gg=gg, table=table,
                order=np.concatenate([[nused], seq]).astype(np.int32),
                delta=delta, n_delta=n_delta, mask=mask, valid=valid,
                perm=perm, want_table=want, m=m, rounds=rounds, C=C)


#: (S, slots in use, R, C, m, rounds, tasks a type): the benchmark cell's
#: state (1,304 slots x 100 rows, 1,297 in use; a round's 8 A, 32 B and 96
#: C) and a small one
CELL = (1304, 1297, 100, 512, 32, 16, {1: 8, 2: 32, 3: 96})
SMALL = (30, 25, 4, 16, 4, 8, {1: 2, 2: 6, 3: 10})
