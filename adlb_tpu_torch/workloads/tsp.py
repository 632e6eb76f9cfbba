"""Branch-and-bound TSP: priority-ordered queue stress + targeted broadcast.

Mirrors the reference's design (reference ``examples/tsp.c``): work units are
partial tours with priority favoring longer partials (depth-first flavor);
each worker keeps a local best-so-far bound; improvements are broadcast as
maximum-priority BOUND_UPDT units targeted along a binary tree of app ranks
(reference ``examples/tsp.c:17,189-192``), so bound propagation exercises
targeting and priority preemption together. Terminates by exhaustion once the
tree is pruned dry.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import struct
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

WORK = 1
BOUND_UPDT = 2
BOUND_PRIO = 999999999  # higher than any work priority (reference tsp.c:17)


def make_cities(n: int, seed: int = 0) -> list[tuple[int, int]]:
    rng = random.Random(seed)
    return [(rng.randint(0, 100), rng.randint(0, 100)) for _ in range(n)]


def dist_matrix(cities) -> list[list[int]]:
    def d(a, b):
        return int(
            round(((a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2) ** 0.5)
        )

    return [[d(a, b) for b in cities] for a in cities]


def brute_force_optimum(dists) -> int:
    """Exact optimum for validation (n small)."""
    n = len(dists)
    best = None
    for perm in itertools.permutations(range(1, n)):
        tour = (0,) + perm
        length = sum(
            dists[tour[i]][tour[(i + 1) % n]] for i in range(n)
        )
        if best is None or length < best:
            best = length
    return best


@dataclasses.dataclass
class TspResult:
    best: int
    tasks_processed: int
    elapsed: float
    tasks_per_sec: float


def run(
    n_cities: int = 9,
    num_app_ranks: int = 4,
    nservers: int = 2,
    seed: int = 0,
    cfg: Optional[Config] = None,
    timeout: float = 180.0,
) -> TspResult:
    cities = make_cities(n_cities, seed)
    dists = dist_matrix(cities)

    def pack(path: list[int], length: int) -> bytes:
        return struct.pack(f"<i{len(path)}i", length, *path)

    def unpack(buf: bytes) -> tuple[int, list[int]]:
        vals = struct.unpack(f"<{len(buf) // 4}i", buf)
        return vals[0], list(vals[1:])

    def greedy_bound() -> int:
        tour, left = [0], set(range(1, n_cities))
        while left:
            nxt = min(left, key=lambda c: dists[tour[-1]][c])
            tour.append(nxt)
            left.remove(nxt)
        return sum(
            dists[tour[i]][tour[(i + 1) % n_cities]] for i in range(n_cities)
        )

    def tree_children(rank: int, nranks: int) -> list[int]:
        return [c for c in (2 * rank + 1, 2 * rank + 2) if c < nranks]

    def app(ctx):
        best = greedy_bound()
        best_known = best
        processed = 0

        def broadcast_bound(val: int) -> None:
            # reference broadcasts improvements down a binary tree of app
            # ranks as max-priority targeted units (tsp.c:189-192)
            for c in tree_children(ctx.rank, ctx.num_app_ranks):
                ctx.put(pack([], val), BOUND_UPDT, BOUND_PRIO, target_rank=c)

        if ctx.rank == 0:
            ctx.put(pack([0], 0), WORK, work_prio=1)
        while True:
            rc, r = ctx.reserve([BOUND_UPDT, WORK])
            if rc != ADLB_SUCCESS:
                return best_known, processed
            rc, buf = ctx.get_reserved(r.handle)
            length, path = unpack(buf)
            if r.work_type == BOUND_UPDT:
                if length < best_known:
                    best_known = length
                    broadcast_bound(length)
                continue
            processed += 1
            if length >= best_known:
                continue  # pruned
            if len(path) == n_cities:
                total = length + dists[path[-1]][0]
                if total < best_known:
                    best_known = total
                    broadcast_bound(total)
                continue
            last = path[-1]
            for city in range(1, n_cities):
                if city in path:
                    continue
                new_len = length + dists[last][city]
                if new_len < best_known:
                    # longer partials get higher priority (tsp.c:239-240)
                    ctx.put(
                        pack(path + [city], new_len), WORK,
                        work_prio=len(path) + 1,
                    )

    t0 = time.monotonic()
    res = run_world(
        num_app_ranks,
        nservers,
        [WORK, BOUND_UPDT],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.15),
        timeout=timeout,
    )
    elapsed = time.monotonic() - t0
    best = min(v[0] for v in res.app_results.values())
    tasks = sum(v[1] for v in res.app_results.values())
    return TspResult(
        best=best,
        tasks_processed=tasks,
        elapsed=elapsed,
        tasks_per_sec=tasks / elapsed if elapsed > 0 else 0.0,
    )
