"""The known-answer workloads in port worlds on the CPU.

Each ported workload (``adlb_tpu_torch.workloads``) runs in a planned-
balancer world (``balancer="tpu"``, ``device="cpu"``, every solve sent to
the device path by ``solver_host_threshold=0``) and must return its known
answer: the n-queens solution count, a valid sudoku, the optimal tour
(brute force), the A/B/C/D economy's counts, every hotspot token consumed
once, every model problem done. ``model`` also runs with
``balancer_mesh="auto"`` (one device here, so the single-device solver
plans). The solutions must match the JAX package's own workloads on the
same inputs, where the answer is a value.
"""

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.workloads import nq as ref_nq
from adlb_tpu.workloads import tsp as ref_tsp
from adlb_tpu_torch.balancer import solve as tsolve
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads import gfmc, hotspot, model, nq, sudoku, tsp

CFG = Config(balancer="tpu", device="cpu", solver_host_threshold=0,
             balancer_max_tasks=64, balancer_max_requesters=16,
             exhaust_check_interval=0.15)


@pytest.fixture
def device_solves():
    """Device solves during the test (the plain version on the CPU)."""
    before = tsolve.solve_counts["device"]
    return lambda: tsolve.solve_counts["device"] - before


@pytest.mark.parametrize("n", [6, 7])
def test_nq_known_answer(n, device_solves):
    res = nq.run(n=n, num_app_ranks=3, nservers=2, cfg=CFG)
    assert res.solutions == nq.KNOWN_SOLUTIONS[n] == ref_nq.KNOWN_SOLUTIONS[n]
    assert res.tasks_processed > 0
    assert device_solves() > 0


def test_tsp_optimal(device_solves):
    dists = tsp.dist_matrix(tsp.make_cities(8, seed=3))
    assert dists == ref_tsp.dist_matrix(ref_tsp.make_cities(8, seed=3))
    want = ref_tsp.brute_force_optimum(dists)
    res = tsp.run(n_cities=8, num_app_ranks=3, nservers=2, seed=3, cfg=CFG)
    assert res.best == want
    assert device_solves() > 0


def test_sudoku_solves():
    res = sudoku.run(num_app_ranks=3, nservers=2, cfg=CFG)
    assert res.valid, "sudoku solution missing or invalid"


def test_gfmc_economy_self_check(device_solves):
    res = gfmc.run(num_a=4, bs_per_a=3, cs_per_b=2, num_app_ranks=4,
                   nservers=2, cfg=CFG)
    assert res.ok, f"counts {res.counts} != expected {res.expected}"
    assert device_solves() > 0


def test_hotspot_consumes_every_token(device_solves):
    res = hotspot.run(n_tasks=120, work_time=0.001, num_app_ranks=5,
                      nservers=2, cfg=CFG)
    assert res.tasks == 120
    assert res.tasks_per_sec > 0
    assert device_solves() > 0


@pytest.mark.parametrize("mesh", ["off", "auto"])
def test_model_all_problems_done(mesh):
    import dataclasses

    cfg = dataclasses.replace(CFG, balancer_mesh=mesh)
    res = model.run(numprobs=12, work_secs=0.005, num_app_ranks=3,
                    nservers=2, cfg=cfg)
    assert res.ok, f"done {res.num_done} != put {res.numprobs}"
