"""c1 — the GFMC-precursor epoch workload with app-level answer messages.

Mirrors the reference ``examples/c1.c``: each slave seeds its share of A
units; an A advances through ``nunits`` time units (re-Put with decaying
priority, reference ``examples/c1.c:186-194``), spawning a B every
``A_EPOCH`` units; a B fans out ``CS_PER_B`` C units (batch put) and then
*gathers* exactly CS_PER_B C-answers — executing pool Cs itself via
non-blocking Ireserve while polling for answers, the reference's
compute/communicate overlap idiom (``examples/c1.c:212-263``). C answers
travel **outside the pool**, as point-to-point messages on app_comm
(``MPI_Send(TAG_C_ANSWER)``, ``examples/c1.c:247,296``) — exercising this
framework's app-messaging layer — and each completed B reports its sum to
the master the same way (``TAG_B_ANSWER``, ``examples/c1.c:267``). The
master counts ``num_As * (nunits // A_EPOCH)`` B answers, then calls
Set_problem_done.

Self-check: master's accumulated sum == num_As * (nunits // A_EPOCH) *
CS_PER_B (reference ``examples/c1.c:116-118``).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_NO_CURRENT_WORK, ADLB_SUCCESS

A_EPOCH = 2  # reference examples/c1.c:10
CS_PER_B = 4  # reference examples/c1.c:11

TAG_B_ANSWER = 1
TAG_C_ANSWER = 2

TYPE_A = 1
TYPE_B = 2
TYPE_C = 3

_A = struct.Struct("<iii")  # (orig_rank, aid, time_unit)
_BC = struct.Struct("<ii")  # (orig_rank, aid)


def _delay(reps: int) -> float:
    v = 2.0
    for _ in range(reps):
        v = math.sqrt(v + 5000000.0) + 1
    return v


@dataclasses.dataclass
class C1Result:
    total: int
    expected: int
    ok: bool


def run(
    num_as: int = 4,
    nunits: int = A_EPOCH * 2,
    num_app_ranks: int = 4,
    nservers: int = 1,
    delay_reps: int = 2000,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
) -> C1Result:
    if num_app_ranks < 2:
        raise ValueError("c1 needs a master and at least one slave")
    num_bs = num_as * (nunits // A_EPOCH)
    expected = num_bs * CS_PER_B
    out: dict = {}

    def master(ctx):
        total = 0
        for _ in range(num_bs):
            payload, _src, tag = ctx.app_recv(apptag=TAG_B_ANSWER)
            assert tag == TAG_B_ANSWER
            total += payload
        ctx.set_problem_done()
        out["total"] = total
        return total

    def gather_c_answers(ctx):
        """B-handler: execute pool Cs while polling for C answers
        (examples/c1.c:212-263)."""
        acc = 0
        n = 0
        while n < CS_PER_B:
            if ctx.app_iprobe(apptag=TAG_C_ANSWER):
                payload, _src, _tag = ctx.app_recv(apptag=TAG_C_ANSWER)
                acc += payload
                n += 1
                continue
            rc, r = ctx.ireserve([TYPE_C])
            if rc == ADLB_SUCCESS:
                rc2, buf = ctx.get_reserved(r.handle)
                if rc2 != ADLB_SUCCESS:
                    return acc, n, rc2
                _delay(delay_reps)
                if r.answer_rank == ctx.rank:
                    acc += 1
                    n += 1
                else:
                    ctx.app_send(r.answer_rank, 1, apptag=TAG_C_ANSWER)
            elif rc == ADLB_NO_CURRENT_WORK:
                # the reference blocks in MPI_Recv here; a bounded wait +
                # re-probe is the hang-proof equivalent
                got = ctx.app_recv(apptag=TAG_C_ANSWER, timeout=0.05)
                if got is not None:
                    acc += got[0]
                    n += 1
            else:
                return acc, n, rc  # NO_MORE_WORK etc.
        return acc, n, ADLB_SUCCESS

    def slave(ctx):
        slaves = num_app_ranks - 1
        base, extra = divmod(num_as, slaves)
        mine = base + (1 if ctx.rank <= extra else 0)
        prio_a = 0
        ctx.begin_batch_put(b"")
        for i in range(mine):
            ctx.put(
                _A.pack(ctx.rank, i + 1, 1),
                TYPE_A,
                work_prio=prio_a,
                answer_rank=ctx.rank,
            )
        ctx.end_batch_put()
        while True:
            rc, r = ctx.reserve()
            if rc != ADLB_SUCCESS:
                return
            if r.work_type == TYPE_A:
                rc, buf = ctx.get_reserved(r.handle)
                if rc != ADLB_SUCCESS:
                    return
                orig, aid, t = _A.unpack(buf)
                _delay(delay_reps)
                if t % A_EPOCH == 0 and t <= nunits:
                    ctx.put(
                        _BC.pack(orig, aid),
                        TYPE_B,
                        work_prio=r.work_prio - 2,
                        answer_rank=ctx.rank,
                    )
                if t < nunits:
                    ctx.put(
                        _A.pack(orig, aid, t + 1),
                        TYPE_A,
                        work_prio=r.work_prio - 3,
                        answer_rank=ctx.rank,
                    )
            elif r.work_type == TYPE_B:
                rc, buf = ctx.get_reserved(r.handle)
                if rc != ADLB_SUCCESS:
                    return
                ctx.begin_batch_put(b"")
                for _ in range(CS_PER_B):
                    ctx.put(
                        buf, TYPE_C, work_prio=r.work_prio + 1,
                        answer_rank=ctx.rank,
                    )
                ctx.end_batch_put()
                acc, _n, rc = gather_c_answers(ctx)
                if rc != ADLB_SUCCESS:
                    return
                ctx.app_send(0, acc, apptag=TAG_B_ANSWER)
            elif r.work_type == TYPE_C:
                rc, buf = ctx.get_reserved(r.handle)
                if rc != ADLB_SUCCESS:
                    return
                _delay(delay_reps)
                # wildcard-reserved C: answer goes back to the B's owner
                # (examples/c1.c:289-297; the self case cannot arise here,
                # the owner only consumes own Cs through gather's Ireserve)
                if r.answer_rank != ctx.rank:
                    ctx.app_send(r.answer_rank, 1, apptag=TAG_C_ANSWER)

    def app(ctx):
        return master(ctx) if ctx.rank == 0 else slave(ctx)

    run_world(
        num_app_ranks,
        nservers,
        [TYPE_A, TYPE_B, TYPE_C],
        app,
        cfg=cfg or Config(),
        timeout=timeout,
    )
    total = out.get("total", -1)
    return C1Result(total=total, expected=expected, ok=total == expected)
