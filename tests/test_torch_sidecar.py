"""The port's planning sidecar driving the native plane (C clients, C++
daemons, the sidecar planning on ``device="cpu"``).

* The five native known-answer workloads (nq, sudoku, gfmc, tsp, hotspot)
  return their answers, and the sidecar's solves take the device route
  (the plain torch version on the CPU), none the numpy host path.
* The sidecar builds its ``PlanEngine`` on ``Config.device``.
* A sidecar whose planning round raises ends the world: ``run_native_world``
  and ``spawn_world`` raise, and nothing plans on numpy afterwards.
"""

import shutil
import threading

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu_torch.balancer import engine as engine_mod
from adlb_tpu_torch.balancer import solve
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads import (
    gfmc_native,
    hotspot_native,
    nq_native,
    sudoku_native,
    tsp_native,
)

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="no C/C++ toolchain")


def _cfg(**kw):
    return Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                  exhaust_check_interval=0.2, **kw)


def _nq():
    r = nq_native.run(n=7, cutoff=2, num_app_ranks=4, nservers=2,
                      cfg=_cfg(), timeout=120.0)
    return r.solutions == r.expected == 40, r


def _sudoku():
    r = sudoku_native.run(n_puzzles=2, num_app_ranks=4, nservers=2,
                          cfg=_cfg(), timeout=120.0)
    return r.valid and r.solved == 2 and r.tasks > 0, r


def _gfmc():
    r = gfmc_native.run(num_a=6, bs_per_a=4, cs_per_b=3, num_app_ranks=4,
                        nservers=2, cfg=_cfg(), timeout=120.0)
    return r.ok and r.tasks == sum(r.expected.values()) + r.expected["c"], r


def _tsp():
    r = tsp_native.run(n_cities=8, num_app_ranks=4, nservers=2, cfg=_cfg(),
                       timeout=120.0)
    return r.optimum is not None and r.best == r.optimum, r


def _hotspot():
    r = hotspot_native.run(n_tasks=200, work_us=1000, num_app_ranks=6,
                           nservers=3, cfg=_cfg(), timeout=120.0)
    return r.tasks == 200 and r.tasks_per_sec > 0, r


WORKLOADS = {"nq": _nq, "sudoku": _sudoku, "gfmc": _gfmc, "tsp": _tsp,
             "hotspot": _hotspot}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_native_workload_known_answer_with_the_sidecar(name):
    before = dict(solve.solve_counts)
    ok, res = WORKLOADS[name]()
    assert ok, res
    assert solve.solve_counts["host"] == before["host"]
    if name == "hotspot":
        # every task enters one server, so the other servers' workers are
        # fed only by the sidecar's plans (the other workloads may finish
        # before a cross-server match is needed)
        assert solve.solve_counts["device"] > before["device"]


def test_nq_matches_the_reference_native_plane():
    from adlb_tpu.runtime.world import Config as RefConfig
    from adlb_tpu.workloads import nq_native as ref_nq_native

    port = nq_native.run(n=8, cutoff=2, num_app_ranks=4, nservers=2,
                         cfg=_cfg(), timeout=120.0)
    ref = ref_nq_native.run(n=8, cutoff=2, num_app_ranks=4, nservers=2,
                            cfg=RefConfig(balancer="tpu",
                                          solver_host_threshold=0,
                                          exhaust_check_interval=0.2),
                            timeout=120.0)
    assert port.solutions == ref.solutions == port.expected == 92


def test_sidecar_plans_on_the_configured_device(monkeypatch):
    devices = []
    real = engine_mod.PlanEngine

    def spy(*args, **kw):
        devices.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(engine_mod, "PlanEngine", spy)
    ok, res = _nq()
    assert ok, res
    assert devices == ["cpu"]


def test_run_native_world_reports_the_sidecars_planning(monkeypatch):
    """The sidecar thread that ``run_native_world`` starts reports its
    solves, rounds and checked solves (``SidecarThread.planner()``) at its
    pseudo-rank, as ``spawn_world`` does."""
    import os

    from adlb_tpu_torch.balancer import sidecar
    from adlb_tpu_torch.native import capi

    threads = []
    real = sidecar.start_sidecar

    def spy(*args, **kw):
        ep, thread = real(*args, **kw)
        threads.append(thread)
        return ep, thread

    monkeypatch.setattr(sidecar, "start_sidecar", spy)
    monkeypatch.setattr(solve, "check_every", 1)
    exe = capi.build_example(os.path.join(capi._REPO, "examples",
                                          "hotspot_c.c"))
    results, stats = capi.run_native_world(
        n_clients=6, nservers=3, types=[1], exe=exe,
        cfg=_cfg(server_impl="native"),
        env_extra={"ADLB_PUT_ROUTING": "home", "ADLB_HOT_NTASKS": "200",
                   "ADLB_HOT_WORK_US": "1000"}, timeout=120.0)
    assert all(rc == 0 for rc, _, _ in results), results
    assert sorted(stats) == [6, 7, 8]
    assert len(threads) == 1
    assert threads[0].world.nranks == 9  # the sidecar: one past the ranks
    counts = threads[0].planner()
    assert counts["device_solves"] > 0 and counts["host_solves"] == 0
    assert counts["greedy_sweep_launches"] == 0  # CPU: the plain version
    assert counts["solves_checked"] == counts["device_solves"]
    assert counts["solves_wrong"] == 0
    assert counts["rounds"] >= counts["device_solves"]
    assert counts["round_s"] > 0


def test_checked_solves_catch_a_wrong_assignment(monkeypatch):
    """A device solve whose result differs from the numpy twin is counted
    in ``solves_wrong``; only every ``check_every``-th solve is kept."""
    import numpy as np

    real = solve.greedy_sweep.greedy_assign_torch
    calls = []

    def off_by_one(*inputs):
        calls.append(1)
        out = real(*inputs)
        return out if len(calls) != 3 else out.roll(1)

    monkeypatch.setattr(solve.greedy_sweep, "greedy_assign_torch", off_by_one)
    monkeypatch.setattr(solve, "check_every", 2)
    solve.reset_counts()
    solver = solve.AssignmentSolver(types=(1, 2), max_tasks=8,
                                    max_requesters=4, host_threshold_reqs=0,
                                    device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(4):
        prio = rng.integers(-50, 50, 16).astype(np.int32)
        kind = rng.integers(0, 2, 16).astype(np.int32)
        mask = rng.random((8, 2)) < 0.6
        solver._device_solve(prio, kind, mask, np.ones(8, bool))
    counts = solve.planner_counts()
    assert counts["device_solves"] == 4
    assert counts["solves_checked"] == 2  # the 1st and the 3rd
    assert counts["solves_wrong"] == 1
    solve.reset_counts()
    assert solve.planner_counts()["solves_checked"] == 0


def _sidecar_threads():
    return [t for t in threading.enumerate()
            if t.name == "adlb-balancer-sidecar" and t.is_alive()]


def _break_planning(monkeypatch):
    rounds = []

    def broken(self, snapshots, world):
        rounds.append(len(snapshots))
        raise RuntimeError("injected planning failure")

    monkeypatch.setattr(engine_mod.PlanEngine, "round", broken)
    return rounds


def test_failed_round_ends_the_native_world(monkeypatch):
    rounds = _break_planning(monkeypatch)
    host = solve.solve_counts["host"]
    with pytest.raises(RuntimeError, match="balancer sidecar failed.*"
                                           "injected planning failure"):
        hotspot_native.run(n_tasks=400, work_us=1000, num_app_ranks=6,
                           nservers=3, cfg=_cfg(), timeout=60.0)
    assert len(rounds) == 1  # the loop ended at its first failure
    assert solve.solve_counts["host"] == host  # no numpy fallback
    assert not _sidecar_threads()


def test_failed_round_ends_a_spawned_native_world(monkeypatch):
    from adlb_tpu_torch.runtime.transport_tcp import spawn_world
    from adlb_tpu_torch.workloads import nq

    rounds = _break_planning(monkeypatch)
    host = solve.solve_counts["host"]
    with pytest.raises(RuntimeError, match="balancer sidecar failed"):
        spawn_world(3, 2, [nq.WORK], _nq_app,
                    cfg=_cfg(server_impl="native"), timeout=60.0)
    assert len(rounds) == 1
    assert solve.solve_counts["host"] == host
    assert not _sidecar_threads()


def _nq_app(ctx):
    from adlb_tpu_torch.workloads import nq

    return nq.app_main(ctx, n=6, max_depth_for_puts=2)
