"""The class decomposition of the greedy solve against the JAX package.

The port's CUDA kernel (``adlb_tpu_torch/csrc/greedy_sweep.cu``) groups the
requesters into classes (same valid, non-empty type mask) and takes one of
three routes; ``requester_classes`` states the rule, and
``greedy_assign_partition_torch`` / ``greedy_assign_classes_torch`` are plain
versions of the first two routes. Here they and the step-by-step plain
version ``greedy_assign_torch`` must equal, exactly, the Pallas sweep run in
interpret mode, the XLA scan ``_greedy_assign`` and the numpy
``_host_greedy`` on the same numpy-seeded instances (the outputs are integer
assignments). The kernel itself is held against them on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

import jax.numpy as jnp

from adlb_tpu.balancer import pallas_solve
from adlb_tpu.balancer.solve import _NEG, _greedy_assign, _host_greedy
from adlb_tpu_torch.balancer import greedy_sweep


def _tasks(rng, nt, t, pad=0.25):
    task_prio = rng.integers(-1000, 1000, size=nt).astype(np.int32)
    task_type = rng.integers(0, t, size=nt).astype(np.int32)
    p = rng.random(nt) < pad
    task_prio[p] = int(_NEG)
    task_type[p] = -1
    return task_prio, task_type


def _random_masks(rng, nr, t, valid=0.8):
    return rng.random((nr, t)) < 0.5, rng.random(nr) < valid


def _world_masks(rng, nr):
    """The phase-3 world of chip_smoke.py: workers reserve types 0-3, the
    master the answer type 4; most slots are empty."""
    rm = np.zeros((nr, 5), dtype=bool)
    rm[:, :4] = True
    rm[0, :] = [False] * 4 + [True]
    return rm, rng.random(nr) < 0.3


def _instance(kind, rng):
    if kind == "partition":  # types in blocks of two, one block each
        tp, tt = _tasks(rng, 300, 8)
        block = rng.integers(0, 4, 90)
        rm = (np.arange(8)[None, :] // 2) == block[:, None]
        return tp, tt, rm, rng.random(90) < 0.9
    if kind == "one_type":  # bench.py's generator
        tp, tt = _tasks(rng, 400, 4, pad=0.0)
        rm = np.zeros((70, 4), dtype=bool)
        rm[np.arange(70), rng.integers(0, 4, 70)] = True
        return tp, tt, rm, np.ones(70, dtype=bool)
    if kind == "nested":  # each mask a prefix of the types
        tp, tt = _tasks(rng, 300, 6)
        rm = np.arange(6)[None, :] < rng.integers(1, 7, 80)[:, None]
        return (tp, tt, rm, rng.random(80) < 0.9)
    if kind == "random":
        return (*_tasks(rng, 300, 4), *_random_masks(rng, 70, 4))
    if kind == "many_classes":  # more than 32 distinct masks
        return (*_tasks(rng, 300, 8), *_random_masks(rng, 150, 8, valid=1.0))
    if kind == "t64":  # the multi-job type axis
        return (*_tasks(rng, 256, 64), *_random_masks(rng, 90, 64))
    if kind == "empty_masks":
        tp, tt = _tasks(rng, 200, 4)
        rm, rv = _random_masks(rng, 77, 4)
        rm[::3] = False
        return tp, tt, rm, rv
    if kind == "invalid_requesters":
        return (*_tasks(rng, 200, 3), *_random_masks(rng, 60, 3, valid=0.3))
    if kind == "all_padding":
        return (np.full(64, int(_NEG), np.int32), np.full(64, -1, np.int32),
                np.ones((40, 3), bool), np.ones(40, bool))
    if kind == "ties":
        tp, tt = _tasks(rng, 300, 4, pad=0.0)
        tp[:] = 7
        return (tp, tt, *_random_masks(rng, 70, 4))
    if kind == "nr_not_multiple_of_32":
        return (*_tasks(rng, 150, 2), *_random_masks(rng, 33, 2))
    if kind == "world":
        tp, tt = _tasks(rng, 512, 5, pad=0.6)
        return (tp, tt, *_world_masks(rng, 96))
    raise ValueError(kind)


#: the kernel's route for each kind of instance
KINDS = {
    "partition": "partition", "one_type": "partition", "nested": "classes",
    "random": "classes", "many_classes": "sweep", "t64": "sweep",
    "empty_masks": "classes", "invalid_requesters": "classes",
    "all_padding": "partition", "ties": "classes",
    "nr_not_multiple_of_32": "classes", "world": "partition",
}


def _plain(fn, arrs):
    return fn(*(torch.from_numpy(a) for a in arrs)).numpy()


@pytest.mark.parametrize("kind", list(KINDS))
def test_routes_match_jax_twins(kind):
    rng = np.random.default_rng(list(KINDS).index(kind) + 40)
    arrs = _instance(kind, rng)
    want = _host_greedy(*arrs)
    j = [jnp.asarray(a) for a in arrs]
    np.testing.assert_array_equal(np.asarray(_greedy_assign(*j)), want)
    np.testing.assert_array_equal(
        np.asarray(pallas_solve.pallas_greedy_assign(*j, interpret=True)),
        want)
    classes = greedy_sweep.requester_classes(torch.from_numpy(arrs[2]),
                                             torch.from_numpy(arrs[3]))
    assert classes.route == KINDS[kind]
    np.testing.assert_array_equal(
        _plain(greedy_sweep.greedy_assign_torch, arrs), want)
    got = _plain(greedy_sweep.greedy_assign_classes_torch, arrs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if classes.route == "partition":
        np.testing.assert_array_equal(
            _plain(greedy_sweep.greedy_assign_partition_torch, arrs), want)
    else:
        with pytest.raises(ValueError, match="partition"):
            _plain(greedy_sweep.greedy_assign_partition_torch, arrs)


def _one_type_masks(rng, nr, t):
    rm = np.zeros((nr, t), dtype=bool)
    rm[np.arange(nr), rng.integers(0, t, nr)] = True
    return rm, np.ones(nr, dtype=bool)


@pytest.mark.parametrize("case,route", [
    ("world", "partition"),
    ("random_t4", "classes"),
    ("random_t64", "sweep"),
    ("random_t11", "sweep"),      # overlapping classes past the 2^T histogram
    ("one_type_t64", "partition"),
    ("one_type_t70", "sweep"),    # past the 64-bit patterns
    ("classes_33", "sweep"),      # one class more than warp lanes
    ("classes_32", "classes"),
    ("no_requesters", "partition"),
])
def test_route_rule(case, route):
    rng = np.random.default_rng(7)
    if case == "world":
        rm, rv = _world_masks(rng, 8192)
    elif case.startswith("random_t"):
        rm, rv = _random_masks(rng, 500, int(case[8:]))
    elif case.startswith("one_type_t"):
        rm, rv = _one_type_masks(rng, 500, int(case[10:]))
    elif case.startswith("classes_"):
        # distinct 7-bit masks that all hold type 0, so none partition
        n = int(case[8:])
        pats = 1 + 2 * np.arange(n)
        rm = (pats[:, None] >> np.arange(7)[None, :]) & 1 == 1
        rv = np.ones(n, dtype=bool)
    else:
        rm, rv = np.zeros((0, 3), bool), np.zeros(0, bool)
    classes = greedy_sweep.requester_classes(torch.from_numpy(rm),
                                             torch.from_numpy(rv))
    assert classes.route == route


@pytest.mark.parametrize("route", ["partition", "classes"])
def test_class_routes_match_host_on_many_random_instances(route):
    rng = np.random.default_rng(23 if route == "partition" else 29)
    fn = {"partition": greedy_sweep.greedy_assign_partition_torch,
          "classes": greedy_sweep.greedy_assign_classes_torch}[route]
    for trial in range(40):
        nt = int(rng.integers(0, 300))
        nr = int(rng.integers(1, 90))
        t = int(rng.integers(1, 7))
        tp, tt = _tasks(rng, nt, t, pad=float(rng.random()))
        if route == "partition":
            rm, rv = _one_type_masks(rng, nr, t)
            rv = rng.random(nr) < float(rng.random())
        else:
            rm, rv = _random_masks(rng, nr, t, valid=float(rng.random()))
        arrs = (tp, tt, rm, rv)
        np.testing.assert_array_equal(_plain(fn, arrs), _host_greedy(*arrs),
                                      err_msg=f"trial {trial}")


def test_c3_reserve_pattern_takes_the_classes_route(monkeypatch):
    """The JAX package's c3 workload (after the reference's examples/c3.c)
    run in a port world: its ranks reserve overlapping type lists
    ([A, A_ANSWER], [C, C_ANSWER], any type, the master's never-put type),
    so a type lies in more than one class and the device solves take the
    kernel's "classes" route, where the plain class chain must equal the
    numpy twin."""
    from adlb_tpu.workloads import c3

    import adlb_tpu_torch
    from adlb_tpu_torch.balancer import solve as tsolve
    from adlb_tpu_torch.runtime.world import Config

    seen = []
    device_solve = tsolve.AssignmentSolver._device_solve

    def kept(self, *arrays):
        seen.append([np.array(a) for a in arrays])
        return device_solve(self, *arrays)

    monkeypatch.setattr(tsolve.AssignmentSolver, "_device_solve", kept)
    monkeypatch.setattr(c3, "run_world", adlb_tpu_torch.run_world)
    res = c3.run(num_app_ranks=6, nservers=2, cfg=Config(
        balancer="tpu", device="cpu", solver_host_threshold=0,
        exhaust_check_interval=0.25), timeout=120)
    assert res.ok, res
    routes = [greedy_sweep.requester_classes(torch.from_numpy(a[2]),
                                             torch.from_numpy(a[3])).route
              for a in seen]
    assert "classes" in routes, routes
    for arrs, route in zip(seen, routes):
        if route == "classes":
            np.testing.assert_array_equal(
                _plain(greedy_sweep.greedy_assign_classes_torch, arrs),
                _host_greedy(*arrs))


def test_counts_before_the_kernel_loads():
    """Without the kernel library (no card) the route tally reads zero and
    reset_counts only zeroes the host-side launch count."""
    assert greedy_sweep._lib is None
    greedy_sweep.launches = 3
    greedy_sweep.reset_counts()
    assert greedy_sweep.launches == 0
    assert greedy_sweep.route_launches() == dict.fromkeys(
        greedy_sweep.ROUTES, 0)
