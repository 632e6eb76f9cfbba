"""GFMC's traffic for the planner: upstream's GFMC model
(``examples/gfmc_c.c``) as the planner sees it, driven by a traffic file's
parameters.

Every server starts with R parked requesters and no tasks. Requester i of
server s is rank s * R + i: rank 0, the master (the first row of the first
server), reserves ``master_reserve`` ([D]); every other rank reserves
``worker_reserve`` ([A, B, C, C_ANSWER]), as upstream's workers loop on one
``ADLB_Reserve``. Each round lands the untargeted work of one round of the
economy: ``per_round`` tasks of each type (8 A, 32 B, 96 C: each A puts 4
B and each B puts 3 C), in an order drawn from the seed, ``burst`` at a
time on ``delta_servers`` servers taken round-robin from ``first_rank``,
each server keeping its K highest-priority tasks; a type's priority is
fixed (``prio``: A 1, B 2, C 3), ties going to the lower gid as in the
planner. Targeted work (C_ANSWER to a B's owner, D to rank 0) never
reaches the planner, so none is made. After the plan, matched tasks leave
their holders and each matched requester re-parks on its own vector at
the end of its home's list with a fresh sequence number. Stamps ride the
snapshots as the engine's do.

So each round's work is the same whatever the seed: 136 tasks, each of a
fixed priority, and requesters in four windows each, C beating B beating
A on every row they share; the seed draws the order the tasks land in.
"""

from __future__ import annotations

import gc

import numpy as np


class Gfmc:
    """The snapshots of ``nservers`` servers (ranks ``first_rank`` up) and
    the rounds' traffic, from ``seed``."""

    def __init__(self, params: dict, nservers: int, K: int, R: int,
                 types, seed: int) -> None:
        self.rng = np.random.default_rng(seed % (1 << 64))
        self.K, self.R, self.S = K, R, nservers
        self.first = int(params["first_rank"])
        self.delta = int(params["delta_servers"])
        self.burst = int(params["burst"])
        mix = {int(t): int(n) for t, n in params["per_round"].items()}
        self.prio = {int(t): int(p) for t, p in params["prio"].items()}
        worker = [int(t) for t in params["worker_reserve"]]
        master = [int(t) for t in params["master_reserve"]]
        known = {int(t) for t in types}
        if (self.delta * self.burst != sum(mix.values())
                or set(mix) - set(self.prio)
                or not set(mix) | set(worker) | set(master) <= known):
            raise ValueError(f"gfmc: {self.delta} x {self.burst} tasks a "
                             f"round for {mix}, priorities {self.prio}, "
                             f"vectors {worker} and {master} over {types}")
        #: the round's task types before the seeded order
        self.bag = np.asarray([t for t, n in sorted(mix.items())
                               for _ in range(n)], dtype=np.int64)
        #: requesters that accept each type: the frozen copy's stop
        self.accepting = {t: (nservers * R - 1) * (t in worker)
                          + (t in master) for t in known}
        self.holding: set = set()  # servers with tasks queued
        self.clock = 1.0
        self.seq = 10**6
        self.rq = 10**7
        self.round = 0
        self.snaps: dict = {}
        # 129,700 tuples: built with the collector off, then moved out of
        # its reach (as the churn's)
        gc.disable()
        try:
            for s in range(nservers):
                st = self._stamp()
                base = s * R
                reqs = [(base + i, i + 1, worker) for i in range(R)]
                if s == 0:
                    reqs[0] = (0, 1, master)
                self.snaps[self.first + s] = {
                    "tasks": [], "reqs": reqs, "stamp": st, "task_stamp": st}
        finally:
            gc.freeze()
            gc.enable()
        self.order = sorted(self.snaps)

    def _stamp(self) -> float:
        self.clock += 1.0
        return self.clock

    def bursts(self) -> None:
        """This round's tasks: the bag in a seeded order, ``burst`` at a
        time on the round's servers."""
        ty = self.rng.permutation(self.bag).tolist()
        prio = self.prio
        for d in range(self.delta):
            sv = self.first + (self.round * self.delta + d) % self.S
            snap = self.snaps[sv]
            lo = d * self.burst
            burst = [(self.seq + i, ty[lo + i], prio[ty[lo + i]], 64)
                     for i in range(self.burst)]
            self.seq += self.burst
            snap["tasks"] = sorted(snap["tasks"] + burst,
                                   key=lambda t: -t[2])[: self.K]
            snap["task_stamp"] = self._stamp()
            self.holding.add(sv)
        self.round += 1

    def consume(self, pairs) -> None:
        """The data plane takes the plan: matched tasks leave, matched
        requesters re-park on their vector."""
        touched: dict = {}
        for holder, seqno, req_home, for_rank, rqseqno in pairs:
            touched.setdefault(holder, set()).add(seqno)
            rs = self.snaps[req_home]
            # a pair that names no parked requester (a wrong plan) re-parks
            # nobody
            vec = next((r[2] for r in rs["reqs"]
                        if r[0] == for_rank and r[1] == rqseqno), None)
            if vec is None:
                continue
            self.rq += 1
            rs["reqs"] = [r for r in rs["reqs"]
                          if not (r[0] == for_rank and r[1] == rqseqno)
                          ] + [(for_rank, self.rq, vec)]
            rs["stamp"] = self._stamp()
        for h, seqs in touched.items():
            hs = self.snaps[h]
            hs["tasks"] = [t for t in hs["tasks"] if t[0] not in seqs]
            hs["task_stamp"] = self._stamp()
            if not hs["tasks"]:
                self.holding.discard(h)

    def frozen(self, C: int) -> dict:
        """The snapshots as far as a round's plan can read them: every
        server holding tasks, and the requester lists of the servers in rank
        order up to the one where each type has the lesser of C and its
        accepting requesters in view (D has one, the master's, on the first
        server), so a handful of servers, not all of them. The generator
        replaces a list and never edits one, so keeping the references is a
        copy."""
        need = {t: min(C, n) for t, n in self.accepting.items() if n}
        out = {}
        for s in self.order:
            if not need:
                break
            v = self.snaps[s]
            out[s] = {"tasks": v["tasks"], "reqs": v["reqs"]}
            for req in v["reqs"][: self.R]:
                for t in req[2]:
                    if t in need:
                        need[t] -= 1
                        if need[t] == 0:
                            del need[t]
        for s in self.holding:
            if s not in out:
                out[s] = {"tasks": self.snaps[s]["tasks"], "reqs": []}
        return out


#: the name a traffic file's ``"generator": "gfmc"`` finds
Generator = Gfmc
