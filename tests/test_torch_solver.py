"""The port's AssignmentSolver against the JAX package's, pair list for pair
list.

Both solvers get the same snapshot dicts (the dict path) and the same
ArrayLedger views (the view path), single-job and multi-job with fair-share
weights, with every solve on the device path (``host_threshold_reqs=0``:
the XLA scan in the reference, the plain torch sweep in the port) and with
the default threshold (the numpy twin below 64 parked requesters). The
reference runs with ``backend="xla"`` on the CPU.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.balancer.solve import AssignmentSolver as RefSolver
from adlb_tpu_torch.balancer import solve as tsolve
from adlb_tpu_torch.balancer.engine import PlanEngine
from adlb_tpu_torch.balancer.solve import AssignmentSolver

TYPES = (1, 2, 3, 4)
WEIGHTS = {1: 3.0, 2: 0.25}


def _snaps(rng, nservers, K, R, J):
    """Random snapshot dicts in the wire's tuple shapes: tasks
    (seqno, type, prio, len[, job]), reqs (rank, rqseqno, types|None
    [, fused, job]); more rows than K / R so truncation is exercised."""
    seq = 0
    out = {}
    for s in range(100, 100 + nservers):
        tasks = []
        for _ in range(int(rng.integers(0, K + 3))):
            seq += 1
            tk = (seq, int(rng.choice(TYPES)), int(rng.integers(-9, 10)), 8)
            if J > 1 and rng.random() < 0.6:
                tk = tk + (int(rng.integers(1, J + 1)),)  # J = overflow job
            tasks.append(tk)
        tasks.sort(key=lambda t: -t[2])
        reqs = []
        for r in range(int(rng.integers(0, R + 2))):
            types = None if rng.random() < 0.2 else sorted(
                {int(rng.choice(TYPES)) for _ in range(int(rng.integers(1, 3)))})
            rq = ((s - 100) * 50 + r, int(rng.integers(1, 1000)), types)
            if J > 1 and rng.random() < 0.6:
                rq = rq + (0, int(rng.integers(1, J + 1)))
            reqs.append(rq)
        out[s] = {"tasks": tasks, "reqs": reqs}
    return out


def _pair(K, R, J, threshold):
    kw = {} if threshold is None else {"host_threshold_reqs": threshold}
    weights = WEIGHTS if J > 1 else None
    ref = RefSolver(types=TYPES, max_tasks=K, max_requesters=R,
                    backend="xla", max_jobs=J, job_weights=weights, **kw)
    port = AssignmentSolver(types=TYPES, max_tasks=K, max_requesters=R,
                            max_jobs=J, job_weights=weights, device="cpu",
                            **kw)
    return ref, port


@pytest.mark.parametrize("threshold", [0, None])
@pytest.mark.parametrize("J", [1, 3])
def test_dict_path_pairs_identical(J, threshold):
    rng = np.random.default_rng(10 * J + (threshold is None))
    ref, port = _pair(K=6, R=4, J=J, threshold=threshold)
    for trial in range(12):
        snaps = _snaps(rng, int(rng.integers(1, 7)), 6, 4, J)
        assert port.solve(snaps, None) == ref.solve(snaps, None), trial
    assert port.solve_count == ref.solve_count
    assert port.host_solve_count == ref.host_solve_count


def test_dict_path_counts_device_solves():
    rng = np.random.default_rng(4)
    _, port = _pair(K=6, R=4, J=1, threshold=0)
    before = dict(tsolve.solve_counts)
    n = 0
    for _ in range(5):
        snaps = _snaps(rng, 4, 6, 4, 1)
        snaps[100]["reqs"].append((999, 1, None))  # at least one requester
        snaps[100]["tasks"].append((10**6, 1, 0, 8))  # and one live task
        port.solve(snaps, None)
        n += 1
    assert tsolve.solve_counts["device"] - before["device"] == n
    assert tsolve.solve_counts["host"] == before["host"]
    assert port.host_solve_count == 0


def test_job_bias_update_matches():
    rng = np.random.default_rng(21)
    ref, port = _pair(K=6, R=4, J=3, threshold=0)
    for weights in ({1: 0.5, 2: 2.0}, None, {2: 4.0}):
        assert port.set_job_bias(weights) == ref.set_job_bias(weights)
        for _ in range(3):
            snaps = _snaps(rng, 5, 6, 4, 3)
            assert port.solve(snaps, None) == ref.solve(snaps, None)


@pytest.mark.parametrize("threshold", [0, None])
@pytest.mark.parametrize("J", [1, 3])
def test_view_path_pairs_identical(J, threshold):
    """The ArrayLedger view the port's engine hands its solver, solved by
    both solvers at the moment it is handed over."""
    ref, _ = _pair(K=6, R=4, J=J, threshold=threshold)
    kw = {} if threshold is None else {"host_threshold_reqs": threshold}
    eng = PlanEngine(types=TYPES, max_tasks=6, max_requesters=4,
                     host_ledger="array", max_jobs=J,
                     job_weights=WEIGHTS if J > 1 else None, device="cpu",
                     **kw)
    port = eng.solver
    seen = []

    def both(view, world):
        assert getattr(view, "is_array", False)
        got = port_solve(view, world)
        assert got == ref.solve(view, world)
        seen.append(len(got))
        return got

    port_solve = port.solve
    port.solve = both
    rng = np.random.default_rng(30 + J)
    for rnd in range(10):
        snaps = _snaps(rng, 5, 6, 4, J)
        for s in snaps.values():
            s.update(stamp=1e9 + rnd, task_stamp=1e9 + rnd, consumers=1)
        eng.round(snaps, None)
    assert seen and sum(seen) > 0
