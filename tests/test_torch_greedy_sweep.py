"""The port's greedy sweep against the JAX package's three twins.

``greedy_assign_torch`` (the plain version the port runs on CPU tensors)
must equal, exactly, the Pallas sweep run in interpret mode, the XLA scan
``_greedy_assign`` and the numpy ``_host_greedy`` on the same numpy-seeded
instances. The outputs are integer assignments, so equality is exact. The
CUDA kernel itself is held against the plain version on the card by
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
from adlb_tpu_torch.balancer import solve as tsolve


def _random_instance(rng, nt, nr, t, pad=0.25):
    task_prio = rng.integers(-1000, 1000, size=nt).astype(np.int32)
    task_type = rng.integers(0, t, size=nt).astype(np.int32)
    p = rng.random(nt) < pad
    task_prio[p] = int(_NEG)
    task_type[p] = -1
    req_mask = rng.random((nr, t)) < 0.5
    req_valid = rng.random(nr) < 0.8
    return task_prio, task_type, req_mask, req_valid


def _bench_instance(rng, nt, nr, t=4):
    """bench.py's solve-scale generator: one type per requester."""
    tp = rng.integers(-50, 50, size=(nt,)).astype(np.int32)
    tt = rng.integers(0, t, size=(nt,)).astype(np.int32)
    rm = np.zeros((nr, t), dtype=bool)
    rm[np.arange(nr), rng.integers(0, t, nr)] = True
    return tp, tt, rm, np.ones((nr,), dtype=bool)


def _case(name, rng):
    if name == "ties":
        tp, tt, rm, rv = _random_instance(rng, 300, 70, 4, pad=0.0)
        tp[:] = 7
        return tp, tt, rm, rv
    if name == "all_padding":
        return (np.full(64, int(_NEG), np.int32), np.full(64, -1, np.int32),
                np.ones((40, 3), bool), np.ones(40, bool))
    if name == "no_valid_requesters":
        tp, tt, rm, _ = _random_instance(rng, 100, 50, 3)
        return tp, tt, rm, np.zeros(50, bool)
    if name == "empty_masks":
        tp, tt, rm, rv = _random_instance(rng, 200, 77, 4)
        rm[::3] = False
        return tp, tt, rm, rv
    if name == "nr_not_multiple_of_32":
        return _random_instance(rng, 150, 33, 2)
    if name == "multi_job_T64":
        return _random_instance(rng, 256, 90, 64)
    if name == "bench_generator":
        return _bench_instance(rng, 512, 64)
    if name == "few_requesters_many_tasks":
        return _random_instance(rng, 1024, 9, 2)
    nt, nr, t = (int(x) for x in name.split("_")[1:])
    return _random_instance(rng, nt, nr, t)


CASES = ["random_16_8_2", "random_64_32_4", "random_200_130_6",
         "random_300_60_4", "ties", "all_padding", "no_valid_requesters",
         "empty_masks", "nr_not_multiple_of_32", "multi_job_T64",
         "bench_generator", "few_requesters_many_tasks"]


def _torch_plain(arrs):
    return greedy_sweep.greedy_assign_torch(
        *(torch.from_numpy(a) for a in arrs)).numpy()


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_twins(name):
    rng = np.random.default_rng(CASES.index(name))
    arrs = _case(name, rng)
    got = _torch_plain(arrs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _host_greedy(*arrs))
    j = [jnp.asarray(a) for a in arrs]
    np.testing.assert_array_equal(got, np.asarray(_greedy_assign(*j)))
    np.testing.assert_array_equal(
        got, np.asarray(pallas_solve.pallas_greedy_assign(*j, interpret=True)))


@pytest.mark.parametrize("slab,big,nt,nr,t", [
    (16 << 10, 16 << 20, 300, 60, 4),  # multi-block int32 sweep
    (16 * 128, 1, 211, 77, 5),         # multi-block int8 upcast sweep
    (16 * 128, 1, 1024, 9, 2),         # early exhaustion skip branch
])
def test_plain_matches_pallas_multiblock(monkeypatch, slab, big, nt, nr, t):
    """The block layouts of tests/test_pallas_solve.py: the Pallas sweep
    runs several grid steps; the port has no blocks and must agree."""
    monkeypatch.setattr(pallas_solve, "_SLAB_BYTES", slab)
    monkeypatch.setattr(pallas_solve, "_BIG_ELEMS", big)
    rng = np.random.default_rng(nt * 7 + nr)
    arrs = _random_instance(rng, nt, nr, t)
    want = np.asarray(pallas_solve.pallas_greedy_assign(
        *(jnp.asarray(a) for a in arrs), interpret=True))
    np.testing.assert_array_equal(_torch_plain(arrs), want)


def test_plain_matches_host_on_many_random_instances():
    rng = np.random.default_rng(11)
    for trial in range(60):
        nt = int(rng.integers(0, 200))
        nr = int(rng.integers(1, 70))
        t = int(rng.integers(1, 6))
        arrs = _random_instance(rng, nt, nr, t, pad=float(rng.random()))
        np.testing.assert_array_equal(
            _torch_plain(arrs), _host_greedy(*arrs), err_msg=f"trial {trial}")


def test_zero_requesters():
    arrs = (np.arange(5, dtype=np.int32), np.zeros(5, np.int32),
            np.zeros((0, 2), bool), np.zeros(0, bool))
    assert _torch_plain(arrs).shape == (0,)


def test_type_bitmasks_pack_valid_and_mask():
    rng = np.random.default_rng(3)
    for nr in (1, 31, 32, 33, 100):
        rm = rng.random((nr, 3)) < 0.5
        rv = rng.random(nr) < 0.7
        words = greedy_sweep.type_bitmasks(
            torch.from_numpy(rm), torch.from_numpy(rv)).numpy()
        assert words.shape == (3, (nr + 31) // 32)
        bits = np.unpackbits(words.view(np.uint32).view(np.uint8),
                             bitorder="little").reshape(3, -1)[:, :nr]
        np.testing.assert_array_equal(bits.astype(bool), (rm & rv[:, None]).T)


def test_wrapper_routes_by_device_and_checks_inputs():
    rng = np.random.default_rng(5)
    ins = [torch.from_numpy(a) for a in _random_instance(rng, 40, 12, 3)]
    np.testing.assert_array_equal(greedy_sweep.greedy_assign(*ins).numpy(),
                                  greedy_sweep.greedy_assign_torch(*ins).numpy())
    before = greedy_sweep.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        greedy_sweep.greedy_assign_cuda(*ins)
    assert greedy_sweep.launches == before  # the CPU route never counts
    with pytest.raises(ValueError, match="int32"):
        greedy_sweep.greedy_assign(ins[0].to(torch.int64), *ins[1:])
    with pytest.raises(ValueError, match="contiguous"):
        greedy_sweep.greedy_assign(ins[0], ins[1], ins[2].T.contiguous().T,
                                   ins[3])
    with pytest.raises(ValueError, match="differ in length"):
        greedy_sweep.greedy_assign(ins[0], ins[1][:-1], ins[2], ins[3])


def test_solver_inputs_from_numpy_hand_off():
    rng = np.random.default_rng(9)
    arrs = _random_instance(rng, 30, 10, 2)
    out = tsolve.solver_inputs_from_numpy(*arrs, torch.device("cpu"))
    assert [t.dtype for t in out] == [torch.int32, torch.int32, torch.bool,
                                     torch.bool]
    for a, t in zip(arrs, out):
        np.testing.assert_array_equal(t.numpy(), a)
