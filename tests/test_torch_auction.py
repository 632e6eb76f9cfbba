"""The sharded planner's auction rounds in the port against the JAX package.

``auction_torch`` (the plain version of ``csrc/auction.cu``) must return,
on the merged candidate lists of ``_merge_shard_major`` and the slot tables
of ``_reqwin``, exactly the commits of the JAX package's numpy twin
``_host_auction`` (the oracle the JAX package fuzz-pins its on-device loop
against), over fuzzed instances spanning the type count, the cand width m,
the shard count and C from ``_slot_sizes``. Tolerance: exact equality
(integer gids). On CPU tensors the dispatching ``auction_windows``, the
one the sharded solver calls, takes the plain versions.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.balancer import distributed as ref
from adlb_tpu_torch.balancer import auction
from adlb_tpu_torch.balancer import distributed as port
from window_churn import assert_windows

NEG = -(2**31) + 1


def _instance(rng, T, m, nshards, rounds, Sl=3, K=6, R=3, dense=False):
    """Per-shard candidates of a random task table (the port's
    ``_shard_candidates``, bit-equal to the JAX package's by
    tests/test_torch_distributed.py), merged by the JAX package's
    ``_merge_shard_major``; requester slot
    tables from ``_reqwin`` on random masks. Returns the reference inputs
    and the port's (tensors)."""
    S = nshards * Sl
    tp = rng.integers(-9, 10, (S, K)).astype(np.int32)
    tt = rng.integers(0, T, (S, K)).astype(np.int32)
    dead = rng.random((S, K)) < (0.05 if dense else 0.3)
    tp[dead] = NEG
    tt[dead & (rng.random((S, K)) < 0.5)] = -1
    rk = rng.permutation(S).astype(np.int32)
    NR = S * R
    C, D = ref._slot_sizes(None, m, rounds, NR)
    cp, cg = port._shard_candidates(
        torch.from_numpy(tp).view(nshards, Sl, K),
        torch.from_numpy(tt).view(nshards, Sl, K),
        torch.from_numpy(rk).view(nshards, Sl), T, D)
    gp, gg = ref._merge_shard_major(cp.numpy(), cg.numpy())
    rm = rng.random((NR, T)) < (0.7 if dense else 0.4)
    rv = rng.random(NR) < 0.85
    rw, lens = ref._reqwin(rm, rv, T, C)
    rwc, open0 = port._compact_reqwin(rw)
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a))
                    for a in (gp, gg, rwc, lens, open0))
    return (gp, gg, rw, lens, rv, rm), tensors


CASES = [(T, m, ns) for T in (1, 4, 8, 24) for m in (1, 8, 32, 40)
         for ns in (1, 2, 8) if not (T == 24 and ns == 8)]


@pytest.mark.parametrize("T,m,nshards", CASES)
def test_auction_torch_equals_host_auction(T, m, nshards):
    rng = np.random.default_rng(1000 * T + 10 * m + nshards)
    for rounds in (1, 3, 16):
        (gp, gg, rw, lens, rv, _), ins = _instance(rng, T, m, nshards, rounds)
        want = ref._host_auction(gp, gg, rw, lens, rv.copy(), rounds, m)
        got = auction.auction_torch(*ins, rounds, m)
        assert got.shape == (T, rw.shape[1] + 1) and got.dtype == torch.int32
        assert np.array_equal(got[:, :-1].numpy(), want), (rounds,)
        assert (got[:, -1] == -1).all()  # the dump column stays empty


def test_auction_dispatch_takes_the_plain_version_on_the_cpu():
    """``auction_windows`` on CPU tensors, the requester table staged whole
    (R = 3 rows a slot, the slots in index order): the windows and commits
    of the JAX package's ``_reqwin`` and ``_host_auction``, no launch."""
    rng = np.random.default_rng(5)
    (gp, gg, rw, lens, rv, rm), ins = _instance(rng, 4, 8, 2, 16,
                                                dense=True)
    want = ref._host_auction(gp, gg, rw, lens, rv.copy(), 16, 8)
    S, T, C = rm.shape[0] // 3, 4, rw.shape[1]
    flags = (rm & rv[:, None]).astype(np.uint8).reshape(-1)
    flags = np.concatenate([flags, np.zeros(-flags.size % 4, np.uint8)])
    delta = np.concatenate([np.arange(S, dtype=np.int32),
                            flags.view(np.int32)])
    table = torch.zeros((3 * S, 1), dtype=torch.int32)
    order = torch.from_numpy(np.arange(-1, S, dtype=np.int32))
    order[0] = S
    launches = auction.launches
    got = auction.auction_windows(*ins[:2], table, order,
                                  torch.from_numpy(delta), S, 16, 8, C)
    n = T * (C + 1)
    assert np.array_equal(got[:n].view(T, C + 1)[:, :-1].numpy(), want)
    assert_windows(got[n:2 * n].view(T, C + 1), rw, lens, gp[:, 0] > NEG)
    assert (want >= 0).sum() > 10  # a real matching, not an empty one
    assert auction.launches == launches  # no kernel launch on the CPU


def test_auction_stops_after_a_round_without_commits():
    """Once every requester is served the loop exits: more rounds change
    nothing, and a single-round budget commits only the first wave."""
    rng = np.random.default_rng(6)
    (gp, gg, rw, lens, rv, _), ins = _instance(rng, 4, 2, 2, 64, Sl=8, R=4,
                                            dense=True)
    full = auction.auction_torch(*ins, 64, 2)
    assert torch.equal(full, auction.auction_torch(*ins, 1000, 2))
    one = auction.auction_torch(*ins, 1, 2)
    assert (one >= 0).sum() <= 4 * 2 < (full >= 0).sum()
    assert np.array_equal(
        one[:, :-1].numpy(),
        ref._host_auction(gp, gg, rw, lens, rv.copy(), 1, 2))


def test_auction_checks_its_inputs():
    rng = np.random.default_rng(7)
    _, (gp, gg, rwc, lens, open0) = _instance(rng, 2, 4, 1, 4)
    order = torch.tensor([1, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        auction.auction_torch(gp.long(), gg, rwc, lens, open0, 4, 4)
    with pytest.raises(ValueError, match="lens"):
        auction.auction_torch(gp, gg, rwc, lens[:1], open0, 4, 4)
    with pytest.raises(ValueError, match="m must be"):
        auction.auction_torch(gp, gg, rwc, lens, open0, 4, 0)
    with pytest.raises(ValueError, match="no auction"):
        auction.auction_windows(gp.to("meta"), gg, rwc, order, order, 0, 4,
                                4, rwc.shape[1])
