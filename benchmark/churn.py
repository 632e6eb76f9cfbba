"""The planner's churn traffic: one general generator, driven by a traffic
file's parameters.

A frozen copy of the steady state of ``adlb_tpu_torch/balancer/plan_bench.py``
(``run_sweep``), so that a later change to the program cannot move it: every
server starts with R parked requesters of one random type each and no
tasks; each round, bursts of ``burst`` tasks (random type and
priority) land on ``delta_servers`` servers taken round-robin, each server
keeping its ``K`` highest-priority tasks; after the plan, matched tasks leave
their holders and each matched requester re-parks at the end of its home's
list with a fresh sequence number and a fresh random type. Stamps ride the
snapshots as the engine's do. Two changes from the copy: the cold pool is
drawn in one call, and a round's draws are made in one call each.

Two parameters fix the work a round makes, whatever the seed (both off
where a traffic file leaves them out, which is the copy above):

* ``"mix": "balanced"``: every server's cold pool and every burst hold each
  type equally often (to one), in an order drawn from the seed, where
  ``"each"`` draws every type on its own;
* ``"repark": "same"``: a matched requester re-parks for the type it had,
  as a worker that asks for the same work again does, where ``"fresh"``
  draws a new one.

With independent draws the types of the requesters in rank order walk at
random round by round, so the rows a plan scans for C requesters of each
type, and with them the card's work, grow over a window and differ from
seed to seed; balanced and re-parked for the same type, every server keeps
its mix and every round has the same number of tasks of each type.
"""

from __future__ import annotations

import gc

import numpy as np


class Churn:
    """The snapshots of ``nservers`` servers (ranks ``first_rank`` up) and
    the rounds' traffic, from ``seed``."""

    def __init__(self, params: dict, nservers: int, K: int, R: int,
                 types, seed: int) -> None:
        self.rng = np.random.default_rng(seed % (1 << 64))
        self.K, self.R, self.S = K, R, nservers
        self.types = np.asarray(types, dtype=np.int64)
        self.first = int(params["first_rank"])
        self.delta = int(params["delta_servers"])
        self.burst = int(params["burst"])
        self.prio_lo, self.prio_hi = params["prio_range"]
        self.mix = params.get("mix", "each")
        self.repark = params.get("repark", "fresh")
        if self.mix not in ("each", "balanced") or self.repark not in (
                "fresh", "same"):
            raise ValueError(f"churn: mix {self.mix!r} or repark "
                             f"{self.repark!r} unknown")
        self.holding: set = set()  # servers with tasks queued
        self.clock = 1.0
        self.seq = 10**6
        self.rq = 10**7
        self.round = 0
        pool = self._draw_types((nservers, R)).tolist()
        self.snaps: dict = {}
        # a million tuples: built with the collector off, then moved out of
        # its reach, so that it neither scans them while they are built nor
        # in the program's collections after
        gc.disable()
        try:
            for s in range(nservers):
                st = self._stamp()
                base = s * 200
                self.snaps[self.first + s] = {
                    "tasks": [],
                    "reqs": [(base + i, i + 1, [t]) for i, t in
                             enumerate(pool[s])],
                    "stamp": st, "task_stamp": st,
                }
        finally:
            gc.freeze()
            gc.enable()
        self.order = sorted(self.snaps)

    def _draw_types(self, shape) -> np.ndarray:
        """Types of the given shape: drawn each on its own, or (balanced)
        each row holding every type equally often, in an order drawn from
        the seed."""
        shape = (1, shape) if isinstance(shape, int) else shape
        if self.mix == "each":
            out = self.types[self.rng.integers(0, len(self.types), shape)]
        else:
            out = self.rng.permuted(
                np.broadcast_to(np.resize(self.types, shape[1]), shape),
                axis=1)
        return out.reshape(-1) if shape[0] == 1 else out

    def _stamp(self) -> float:
        self.clock += 1.0
        return self.clock

    def bursts(self) -> None:
        """This round's task bursts."""
        n = self.delta * self.burst
        ty = (self._draw_types(n) if self.mix == "each" else
              self._draw_types((self.delta, self.burst)).reshape(-1)).tolist()
        pr = self.rng.integers(self.prio_lo, self.prio_hi, n).tolist()
        for d in range(self.delta):
            sv = self.first + (self.round * self.delta + d) % self.S
            snap = self.snaps[sv]
            lo = d * self.burst
            burst = [(self.seq + i, ty[lo + i], pr[lo + i], 64)
                     for i in range(self.burst)]
            self.seq += self.burst
            snap["tasks"] = sorted(snap["tasks"] + burst,
                                   key=lambda t: -t[2])[: self.K]
            snap["task_stamp"] = self._stamp()
            self.holding.add(sv)
        self.round += 1

    def consume(self, pairs) -> None:
        """The data plane takes the plan: matched tasks leave, matched
        requesters re-park with a fresh type."""
        fresh = (self.types[self.rng.integers(0, len(self.types),
                                              max(len(pairs), 1))].tolist()
                 if self.repark == "fresh" else None)
        touched: dict = {}
        for i, (holder, seqno, req_home, for_rank, rqseqno) in enumerate(
                pairs):
            touched.setdefault(holder, set()).add(seqno)
            rs = self.snaps[req_home]
            self.rq += 1
            keep = [r for r in rs["reqs"]
                    if not (r[0] == for_rank and r[1] == rqseqno)]
            if fresh is not None:
                ty = [fresh[i]]
            else:
                # a pair that names no parked requester (a wrong plan)
                # re-parks nobody
                ty = next((r[2] for r in rs["reqs"]
                           if r[0] == for_rank and r[1] == rqseqno), None)
                if ty is None:
                    continue
            rs["reqs"] = keep + [(for_rank, self.rq, ty)]
            rs["stamp"] = self._stamp()
        for h, seqs in touched.items():
            hs = self.snaps[h]
            hs["tasks"] = [t for t in hs["tasks"] if t[0] not in seqs]
            hs["task_stamp"] = self._stamp()
            if not hs["tasks"]:
                self.holding.discard(h)

    def frozen(self, C: int) -> dict:
        """The snapshots as they stand, as far as a round's plan can read
        them: every server holding tasks, and the requester lists of the
        servers in rank order up to the one where each type has C
        requesters in view (the plan takes each type's first C, in that
        order; the requesters after them cannot be planned this round, so
        the copy gives the later servers none). The generator replaces a
        list and never edits one, so keeping the references is a copy. A
        few dozen entries, not one a server: the copies kept over the
        window stay out of the collector's way."""
        need = {int(t): C for t in self.types}
        out = {}
        for s in self.order:
            if not need:
                break
            v = self.snaps[s]
            out[s] = {"tasks": v["tasks"], "reqs": v["reqs"]}
            for req in v["reqs"][: self.R]:
                for t in (list(need) if req[2] is None else req[2]):
                    if t in need:
                        need[t] -= 1
                        if need[t] == 0:
                            del need[t]
        for s in self.holding:
            if s not in out:
                out[s] = {"tasks": self.snaps[s]["tasks"], "reqs": []}
        return out


#: the name a traffic file's ``"generator": "churn"`` finds (the default)
Generator = Churn
