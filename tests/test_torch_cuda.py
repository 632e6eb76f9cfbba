"""Card-only tests of the port's CUDA kernel (the kernel has no CPU mode):
every route at the main path's shape, the route the kernel reports against
``requester_classes``, one launch per device solve, and requester counts
whose working set does not fit in shared memory (the kernel's scratch
buffer in device memory).

They skip without a CUDA device. This file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from adlb_tpu_torch.balancer import greedy_sweep
from adlb_tpu_torch.balancer.solve import _NEG, AssignmentSolver, _host_greedy


def _random_instance(rng, nt, nr, t, pad=0.25):
    task_prio = rng.integers(-1000, 1000, size=nt).astype(np.int32)
    task_type = rng.integers(0, t, size=nt).astype(np.int32)
    p = rng.random(nt) < pad
    task_prio[p] = int(_NEG)
    task_type[p] = -1
    return (task_prio, task_type, rng.random((nr, t)) < 0.5,
            rng.random(nr) < 0.8)


def _bench_instance(rng, nt, nr, t=4):
    tp = rng.integers(-50, 50, size=(nt,)).astype(np.int32)
    tt = rng.integers(0, t, size=(nt,)).astype(np.int32)
    rm = np.zeros((nr, t), dtype=bool)
    rm[np.arange(nr), rng.integers(0, t, nr)] = True
    return tp, tt, rm, np.ones((nr,), dtype=bool)


#: one 65536 x 8192 instance per route: bench.py's generator, random masks
#: at T=4, random masks at T=64
ROUTE_CASES = {"partition": lambda rng: _bench_instance(rng, 65536, 8192),
               "classes": lambda rng: _random_instance(rng, 65536, 8192, 4),
               "sweep": lambda rng: _random_instance(rng, 65536, 8192, 64)}


def _route(arrs):
    return greedy_sweep.requester_classes(
        torch.from_numpy(arrs[2]), torch.from_numpy(arrs[3])).route


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nt,nr,t", [
    (16, 8, 2), (200, 130, 6), (1024, 9, 2), (5000, 1000, 3),
    (4096, 700, 64), (9000, 33, 4), (30000, 9000, 7), (5000, 2000, 70)])
def test_kernel_matches_plain_and_host(card, nt, nr, t):
    rng = np.random.default_rng(nt + nr + t)
    for _ in range(3):
        arrs = _random_instance(rng, nt, nr, t)
        ins = [torch.from_numpy(a).to(card) for a in arrs]
        got, code = greedy_sweep.solve_cuda(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got, greedy_sweep.greedy_assign_torch(*ins))
        np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))
        assert greedy_sweep.ROUTES[int(code) - 1] == _route(arrs)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTE_CASES))
def test_each_route_at_main_path_shape(card, route):
    arrs = ROUTE_CASES[route](np.random.default_rng(17))
    assert _route(arrs) == route
    ins = [torch.from_numpy(a).to(card) for a in arrs]
    got, code = greedy_sweep.solve_cuda(*ins)
    torch.cuda.synchronize()
    assert greedy_sweep.ROUTES[int(code) - 1] == route
    np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))
    assert torch.equal(got, greedy_sweep.greedy_assign_torch(*ins))


@pytest.mark.cuda
def test_solver_device_solve_is_one_launch(card):
    """The main path's hand-off: one launch per device solve, counted under
    the route it took, the buffers kept while the shape holds."""
    solver = AssignmentSolver(types=(1, 2, 3, 4), max_tasks=4096,
                              max_requesters=512, host_threshold_reqs=0)
    rng = np.random.default_rng(19)
    for route in ("partition", "classes", "partition"):
        arrs = ROUTE_CASES[route](rng)
        before, routes = greedy_sweep.launches, greedy_sweep.route_launches()
        got = solver._device_solve(*arrs)
        assert greedy_sweep.launches == before + 1
        assert greedy_sweep.route_launches()[route] == routes[route] + 1
        np.testing.assert_array_equal(got, _host_greedy(*arrs))
    handoff = solver.handoff
    solver._device_solve(*ROUTE_CASES["partition"](rng))
    assert solver.handoff is handoff


#: (tasks, requesters, types, masks) past what shared memory holds: 32
#: servers x 2048 requesters, and 16 x 2048 with 4 types x 16 jobs (T=64)
LARGE = {"classes_nr65536": (16384, 65536, 4, "random"),
         "partition_nr65536": (16384, 65536, 4, "one_type"),
         "sweep_t64_nr32768": (16384, 32768, 64, "random"),
         "sweep_t11_nr65536": (16384, 65536, 11, "random")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LARGE))
def test_kernel_past_shared_memory(card, case):
    nt, nr, t, masks = LARGE[case]
    rng = np.random.default_rng(nr + t)
    arrs = (_random_instance(rng, nt, nr, t) if masks == "random"
            else _bench_instance(rng, nt, nr, t))
    route = _route(arrs)
    assert route == case.split("_")[0]
    ins = [torch.from_numpy(a).to(card) for a in arrs]
    got, code = greedy_sweep.solve_cuda(*ins)
    torch.cuda.synchronize()
    assert greedy_sweep.ROUTES[int(code) - 1] == route
    np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))
    assert greedy_sweep.Workspace(nt, nr, t, card).scratch is not None


@pytest.mark.cuda
def test_solver_at_32_servers_x_2048_requesters(card):
    """The hand-off at NR = 65,536 (scratch in device memory) against the
    numpy twin, one launch per solve."""
    solver = AssignmentSolver(types=(1, 2, 3, 4), max_tasks=512,
                              max_requesters=2048, host_threshold_reqs=0)
    rng = np.random.default_rng(23)
    for make in (_random_instance, _bench_instance):
        arrs = make(rng, 32 * 512, 32 * 2048, 4)
        before = greedy_sweep.launches
        got = solver._device_solve(*arrs)
        assert greedy_sweep.launches == before + 1
        np.testing.assert_array_equal(got, _host_greedy(*arrs))
    assert solver.handoff.work.scratch is not None


@pytest.mark.cuda
def test_kernel_main_path_shape_counts_one_launch(card):
    rng = np.random.default_rng(0)
    arrs = _bench_instance(rng, 65536, 8192)
    ins = [torch.from_numpy(a).to(card) for a in arrs]
    before = greedy_sweep.launches
    got = greedy_sweep.greedy_assign(*ins)
    torch.cuda.synchronize()
    assert greedy_sweep.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(card):
    ins = [torch.from_numpy(a).to(card) for a in
           _random_instance(np.random.default_rng(2), 50, 20, 3)]
    with pytest.raises(ValueError, match="int32"):
        greedy_sweep.greedy_assign(ins[0].to(torch.int64), *ins[1:])
    with pytest.raises(ValueError, match="task_prio on"):
        greedy_sweep.greedy_assign(ins[0], ins[1].cpu(), *ins[2:])
