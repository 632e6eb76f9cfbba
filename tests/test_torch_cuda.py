"""Card-only tests of the port's CUDA kernel (the kernel has no CPU mode).

They skip without a CUDA device. This file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from adlb_tpu_torch.balancer import greedy_sweep
from adlb_tpu_torch.balancer.solve import _NEG, _host_greedy


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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nt,nr,t", [
    (16, 8, 2), (200, 130, 6), (1024, 9, 2), (5000, 1000, 3),
    (4096, 700, 64), (9000, 33, 4)])
def test_kernel_matches_plain_and_host(card, nt, nr, t):
    rng = np.random.default_rng(nt + nr + t)
    for _ in range(3):
        arrs = _random_instance(rng, nt, nr, t)
        ins = [torch.from_numpy(a).to(card) for a in arrs]
        got = greedy_sweep.greedy_assign(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got, greedy_sweep.greedy_assign_torch(*ins))
        np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))


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
