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


# The rest of the JAX package's workloads: each runs in a planned port world
# (CFG) and in a JAX-package world with the same arguments under that
# workload's own default Config (the answers are values that do not depend
# on the balancer), and both must give the same answer.

from adlb_tpu.workloads import add2 as ref_add2  # noqa: E402
from adlb_tpu.workloads import batcher as ref_batcher  # noqa: E402
from adlb_tpu.workloads import c1 as ref_c1  # noqa: E402
from adlb_tpu.workloads import c3 as ref_c3  # noqa: E402
from adlb_tpu.workloads import coinop as ref_coinop  # noqa: E402
from adlb_tpu.workloads import grid as ref_grid  # noqa: E402
from adlb_tpu.workloads import partest as ref_partest  # noqa: E402
from adlb_tpu.workloads import pmcmc as ref_pmcmc  # noqa: E402
from adlb_tpu.workloads import skel as ref_skel  # noqa: E402
from adlb_tpu.workloads import trickle as ref_trickle  # noqa: E402
from adlb_tpu_torch.workloads import (  # noqa: E402
    add2,
    batcher,
    c1,
    c3,
    coinop,
    grid,
    partest,
    pmcmc,
    skel,
    trickle,
)


def _answer(pkg, name, cfg):
    """(the workload's answer, whether it checked itself) for one
    package's workload module ``pkg`` at this file's small sizes."""
    if name == "add2":
        r = pkg.run([(i, 2 * i + 1) for i in range(30)], num_app_ranks=3,
                    nservers=2, cfg=cfg)
        return (r.total, r.expected), r.ok
    if name == "batcher":
        d = [0.02, 0.01, 0.01, 0.005, 0.005, 0.01]
        r = pkg.run(d, num_app_ranks=4, nservers=2, cfg=cfg)
        return (sum(r.jobs_run.values()), r.serial_time), True
    if name == "c1":
        r = pkg.run(num_as=3, nunits=4, num_app_ranks=4, nservers=2,
                    delay_reps=200, cfg=cfg)
        return (r.total, r.expected), r.ok
    if name == "c3":
        r = pkg.run(nas=4, nbs=2, ncs=3, loop1=2, loop2=2, atime=0.002,
                    ctime=0.001, num_app_ranks=4, nservers=2, cfg=cfg)
        return (r.a_answers, r.c_answers, r.exp_as, r.exp_cs), r.ok
    if name == "coinop":
        r = pkg.run(n_tokens=120, num_app_ranks=4, nservers=2, cfg=cfg)
        return r.pops, r.latency_p50_ms > 0 and bool(r.per_worker)
    if name == "grid":
        r = pkg.run(6, 5, 3, num_app_ranks=3, nservers=2, cfg=cfg)
        want = pkg.run_sequential(6, 5, 3)
        return (r.grid.tolist(), r.average), bool(
            (r.grid == want).all() and sum(r.rows_computed.values()) == 18)
    if name == "pmcmc":
        r = pkg.run(num_mcs=4, steps=800, num_app_ranks=3, nservers=2,
                    cfg=cfg)
        return {k: v.tolist() for k, v in r.solutions.items()}, r.ok
    if name == "skel":
        r = pkg.run(num_app_ranks=4, nservers=2, cfg=cfg)
        return (r.produced, r.consumed), r.ok
    if name == "trickle":
        r = pkg.run(n_tasks=40, interval=0.005, group=2, work_time=0.001,
                    num_app_ranks=6, nservers=3, cfg=cfg, timeout=120.0)
        return r.tasks, r.dispatch_p50_ms > 0
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["add2", "batcher", "c1", "c3", "coinop",
                                  "grid", "pmcmc", "skel", "trickle"])
def test_workload_matches_the_jax_package(name):
    import importlib

    host = tsolve.solve_counts["host"]
    ref = importlib.import_module(f"adlb_tpu.workloads.{name}")
    port = importlib.import_module(f"adlb_tpu_torch.workloads.{name}")
    want, ref_ok = _answer(ref, name, None)
    got, ok = _answer(port, name, CFG)
    assert ref_ok and ok
    assert got == want
    assert tsolve.solve_counts["host"] == host  # every solve on the device path


def test_partest_matches_the_jax_package():
    """partest has no world: its nugget and its calibrated units replay the
    same loop counts in both packages, and the port's units run through a
    planned port world, each replayed once."""
    assert partest.nugget(300) == ref_partest.nugget(300)
    unit = partest.define_work(0.01, nugget_reps=50)
    assert (unit.i, unit.j, unit.k) >= (0, 0, 0)
    assert 0 < partest.do_work(unit, nugget_reps=50) < 5.0
    import pickle

    import adlb_tpu_torch

    units = [partest.define_work(0.002 * (1 + i % 3), nugget_reps=20)
             for i in range(12)]

    def app(ctx):
        if ctx.rank == 0:
            for i, u in enumerate(units):
                ctx.put(pickle.dumps((i, u)), 1)
        done = []
        while True:
            rc, r = ctx.reserve([1])
            if rc != adlb_tpu_torch.ADLB_SUCCESS:
                return done
            rc, buf = ctx.get_reserved(r.handle)
            i, u = pickle.loads(buf)
            partest.do_work(u, nugget_reps=20)
            done.append(i)

    res = adlb_tpu_torch.run_world(num_app_ranks=3, nservers=2, types=[1],
                                   app_fn=app, cfg=CFG, timeout=60)
    assert sorted(i for v in res.app_results.values() for i in v) == \
        list(range(12))
