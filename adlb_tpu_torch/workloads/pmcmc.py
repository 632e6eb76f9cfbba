"""Embarrassingly-parallel Markov Chain Monte Carlo (hard-disk problem).

Mirrors the reference's pmcmc demo (reference ``examples/pmcmc.c``): the
master rank Puts integer RNG seeds as WORK units; each worker pulls a seed,
runs a Metropolis chain proposing random moves of four hard disks in the
unit box (a move is accepted if the disk stays inside the ``sigma`` margin
and clears every other disk), and Puts the final disk positions back as a
SOLN unit *targeted* at the master (reference ``examples/pmcmc.c:208``,
``target_rank=0``). The master Reserves exactly one SOLN per seed with a
type-filtered reserve, then declares the problem done.

Validation: solutions are seed-deterministic, every returned configuration
must respect the margin and the pairwise separation invariant, and the
master must collect exactly ``num_mcs`` solutions.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

import numpy as np

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

WORK, SOLN = 1, 2

NUMDISKS = 4
SIGMA = 0.20
DELTA = 0.15
_SEP = SIGMA * SIGMA  # the reference compares distance against sigma^2


def chain(seed: int, steps: int) -> np.ndarray:
    """Run one Metropolis chain; returns the final [NUMDISKS, 2] positions.

    Same model as the reference's worker body (``examples/pmcmc.c:155-205``):
    start from the 4-disk lattice, propose uniform moves in
    ``[-DELTA, DELTA]^2`` for a random disk, accept iff inside the margin
    and at least ``SIGMA**2`` from every other disk. Proposals are drawn in
    one vectorized batch; the accept/update loop is inherently sequential.
    """
    rng = np.random.default_rng(seed)
    pts = np.array(
        [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]], dtype=np.float64
    )
    choices = rng.integers(0, NUMDISKS, size=steps)
    moves = rng.uniform(-DELTA, DELTA, size=(steps, 2))
    lo, hi = SIGMA, 1.0 - SIGMA
    for k in range(steps):
        c = choices[k]
        b = pts[c] + moves[k]
        if b[0] < lo or b[0] > hi or b[1] < lo or b[1] > hi:
            continue
        d = pts - b
        dist = np.sqrt(np.einsum("ij,ij->i", d, d))
        dist[c] = np.inf
        if (dist >= _SEP).all():
            pts[c] = b
    return pts


def valid_config(pts: np.ndarray) -> bool:
    lo, hi = SIGMA, 1.0 - SIGMA
    if (pts < lo).any() or (pts > hi).any():
        return False
    for i in range(NUMDISKS):
        for j in range(i + 1, NUMDISKS):
            if float(np.linalg.norm(pts[i] - pts[j])) < _SEP:
                return False
    return True


@dataclasses.dataclass
class PmcmcResult:
    ok: bool
    solutions: dict[int, np.ndarray]  # seed -> final positions
    elapsed: float
    chains_per_sec: float


def run(
    num_mcs: int = 8,
    steps: int = 4000,
    num_app_ranks: int = 4,
    nservers: int = 1,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
) -> PmcmcResult:
    fmt_soln = f"<i{NUMDISKS * 2}d"

    def app(ctx):
        if ctx.rank == 0:
            for i in range(num_mcs):
                ctx.put(struct.pack("<i", i + 100), WORK, work_prio=1)
            solutions: dict[int, np.ndarray] = {}
            for _ in range(num_mcs):
                rc, r = ctx.reserve([SOLN])
                assert rc == ADLB_SUCCESS and r.work_type == SOLN, (
                    f"master reserve failed rc={rc}"
                )
                rc, buf = ctx.get_reserved(r.handle)
                vals = struct.unpack(fmt_soln, buf)
                solutions[vals[0]] = np.array(vals[1:]).reshape(NUMDISKS, 2)
            ctx.set_problem_done()
            return solutions
        while True:
            rc, r = ctx.reserve([WORK])
            if rc != ADLB_SUCCESS:
                return {}
            rc, buf = ctx.get_reserved(r.handle)
            (seed,) = struct.unpack("<i", buf)
            pts = chain(seed, steps)
            ctx.put(
                struct.pack(fmt_soln, seed, *pts.ravel().tolist()),
                SOLN,
                work_prio=2,
                target_rank=0,
            )

    t0 = time.monotonic()
    res = run_world(
        num_app_ranks,
        nservers,
        [WORK, SOLN],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.2),
        timeout=timeout,
    )
    elapsed = time.monotonic() - t0
    solutions = res.app_results[0]
    ok = len(solutions) == num_mcs and all(
        valid_config(p) for p in solutions.values()
    )
    return PmcmcResult(
        ok=ok,
        solutions=solutions,
        elapsed=elapsed,
        chains_per_sec=num_mcs / elapsed if elapsed > 0 else 0.0,
    )
