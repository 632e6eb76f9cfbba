"""c3 — batch-generation GFMC variant with answer economy over the pool.

Mirrors the reference ``examples/c3.c``: a small subset of slaves
(``num_app_ranks/20``, at least 1 — reference ``examples/c3.c:106-108``)
runs a two-level generation loop: per (loop1, loop2) a *batch* of A units is
Put, then the generator reserves ``[TYPE_A, TYPE_A_ANSWER]`` until every A
of the batch is answered — executing As itself and counting directly when
``answer_rank`` is itself, else shipping a **targeted** TYPE_A_ANSWER unit
back through the pool (reference ``examples/c3.c:196-249``). Per loop1 it
then Puts a batch of Bs. All slaves join the wildcard phase-2 loop: an A is
executed and answered with a targeted A_ANSWER; a B fans out a batch of Cs
and gathers ``[TYPE_C, TYPE_C_ANSWER]`` (C answers always travel as
targeted C_ANSWER units, even to self — reference ``examples/c3.c:391-404``);
a wildcard C is executed and answered likewise. The master parks on
``TYPE_NEVER_PUT_FOR_MASTER`` so only exhaustion releases it (reference
``examples/c3.c:151-166``) — the whole run terminates **by exhaustion**.

Self-check (reference ``examples/c3.c:458-463``): summed A answers ==
``n1 * loop1 * loop2 * nas`` and summed C answers == ``n1 * loop1 * nbs *
ncs``.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

TYPE_A = 1
TYPE_A_ANSWER = 2
TYPE_B = 3
TYPE_C = 4
TYPE_C_ANSWER = 5
TYPE_NEVER_PUT_FOR_MASTER = 6

PRIO_A, PRIO_B, PRIO_C = 3, 2, 1
PRIO_ANSWER = 9

_U = struct.Struct("<iii")  # (orig_rank, uid, cidx)


def _fake_work(secs: float) -> None:
    t0 = time.perf_counter()
    v = 99.99
    while time.perf_counter() - t0 < secs:
        v = math.sqrt(v + 50000.0) + 1.0


@dataclasses.dataclass
class C3Result:
    a_answers: int
    c_answers: int
    exp_as: int
    exp_cs: int
    ok: bool


def run(
    nas: int = 6,
    nbs: int = 3,
    ncs: int = 4,
    loop1: int = 2,
    loop2: int = 2,
    atime: float = 0.002,
    ctime: float = 0.001,
    num_app_ranks: int = 4,
    nservers: int = 1,
    cfg: Optional[Config] = None,
    timeout: float = 180.0,
) -> C3Result:
    if num_app_ranks < 2:
        raise ValueError("c3 needs a master and at least one slave")
    n1 = max(num_app_ranks // 20, 1)  # slaves doing the generation phase
    exp_as = n1 * loop1 * loop2 * nas
    exp_bs = n1 * loop1 * nbs
    exp_cs = exp_bs * ncs

    def master(ctx):
        rc, _ = ctx.reserve([TYPE_NEVER_PUT_FOR_MASTER])
        assert rc != ADLB_SUCCESS  # only exhaustion/NMW releases the master
        return (0, 0)

    def handle_c_gather(ctx, n_expected: int):
        """Reserve [C, C_ANSWER] until n_expected answers (c3.c:355-419)."""
        n = 0
        while n < n_expected:
            rc, r = ctx.reserve([TYPE_C, TYPE_C_ANSWER])
            if rc != ADLB_SUCCESS:
                return n, rc
            rc2, buf = ctx.get_reserved(r.handle)
            if rc2 != ADLB_SUCCESS:
                return n, rc2
            if r.work_type == TYPE_C:
                _fake_work(ctime)
                ctx.put(buf, TYPE_C_ANSWER, work_prio=PRIO_ANSWER,
                        target_rank=r.answer_rank)
            else:
                n += 1
        return n, ADLB_SUCCESS

    def slave(ctx):
        a_answers = 0
        c_answers = 0
        num_as = num_bs = 0
        if 1 <= ctx.rank <= n1:  # generation phase
            for _l1 in range(loop1):
                for _l2 in range(loop2):
                    ctx.begin_batch_put(b"")
                    for _ in range(nas):
                        num_as += 1
                        ctx.put(_U.pack(ctx.rank, num_as, 0), TYPE_A,
                                work_prio=PRIO_A, answer_rank=ctx.rank)
                    ctx.end_batch_put()
                    got = 0
                    while got < nas:
                        rc, r = ctx.reserve([TYPE_A, TYPE_A_ANSWER])
                        assert rc == ADLB_SUCCESS, (
                            "exhaustion before all A answers")
                        rc2, buf = ctx.get_reserved(r.handle)
                        assert rc2 == ADLB_SUCCESS
                        if r.work_type == TYPE_A:
                            _fake_work(atime)
                            if r.answer_rank == ctx.rank:
                                got += 1
                                a_answers += 1
                            else:
                                ctx.put(buf, TYPE_A_ANSWER,
                                        work_prio=PRIO_ANSWER,
                                        target_rank=r.answer_rank)
                        else:
                            got += 1
                            a_answers += 1
                ctx.begin_batch_put(b"")
                for _ in range(nbs):
                    num_bs += 1
                    ctx.put(_U.pack(ctx.rank, num_bs, 0), TYPE_B,
                            work_prio=PRIO_B, answer_rank=ctx.rank)
                ctx.end_batch_put()
        # phase 2: everyone drains the pool until exhaustion
        while True:
            rc, r = ctx.reserve()
            if rc != ADLB_SUCCESS:
                break
            rc2, buf = ctx.get_reserved(r.handle)
            if rc2 != ADLB_SUCCESS:
                break
            if r.work_type == TYPE_A:
                _fake_work(atime)
                ctx.put(buf, TYPE_A_ANSWER, work_prio=PRIO_ANSWER,
                        target_rank=r.answer_rank)
            elif r.work_type == TYPE_A_ANSWER:
                a_answers += 1
            elif r.work_type == TYPE_B:
                orig, uid, _ = _U.unpack(buf)
                ctx.begin_batch_put(b"")
                for i in range(ncs):
                    ctx.put(_U.pack(orig, uid, i), TYPE_C,
                            work_prio=PRIO_C, answer_rank=ctx.rank)
                ctx.end_batch_put()
                got, rc = handle_c_gather(ctx, ncs)
                c_answers += got
                if rc != ADLB_SUCCESS:
                    break
            elif r.work_type == TYPE_C:
                _fake_work(ctime)
                ctx.put(buf, TYPE_C_ANSWER, work_prio=PRIO_ANSWER,
                        target_rank=r.answer_rank)
            elif r.work_type == TYPE_C_ANSWER:
                c_answers += 1
        return (a_answers, c_answers)

    def app(ctx):
        return master(ctx) if ctx.rank == 0 else slave(ctx)

    res = run_world(
        num_app_ranks,
        nservers,
        [TYPE_A, TYPE_A_ANSWER, TYPE_B, TYPE_C, TYPE_C_ANSWER,
         TYPE_NEVER_PUT_FOR_MASTER],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.25),
        timeout=timeout,
    )
    a_total = sum(a for a, _ in res.app_results.values())
    c_total = sum(c for _, c in res.app_results.values())
    return C3Result(
        a_answers=a_total,
        c_answers=c_total,
        exp_as=exp_as,
        exp_cs=exp_cs,
        ok=a_total == exp_as and c_total == exp_cs,
    )
