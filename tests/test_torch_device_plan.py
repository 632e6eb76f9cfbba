"""The sharded planner's device plan, as two kernels' plain versions, against
the JAX package (all on the CPU).

A device plan is one launch of ``csrc/candidates.cu`` (every shard's top-D
candidates of each type and their cross-shard merge, cut to [T, D]) and one
launch of ``csrc/auction.cu`` over those [T, D] lists. On the CPU both run
their plain versions, which this file holds against the JAX package's
``_shard_candidates`` (jitted on the CPU, one shard at a time: its
``shard_map`` tier cannot be built under the installed jax), its numpy merge
``_merge_shard_major`` and its numpy auction ``_host_auction`` over the full
[T, nshards * D] merge. Instances come from a numpy seed and are
parametrised over nshards in {1, 2, 8}, jobs J in {1, 2} (T = 4 J types,
prios biased past the clip as a job weight biases them) and with and
without truncation (more than D live slots of a type in a shard). Exact
equality throughout: priorities and ids are integers.

The tie rule the kernel relies on is pinned too: equal keys are equal
(prio, gid) pairs, so the candidates do not depend on which of two slots
with the same pair comes first, and the solver's live gids are unique
anyway (ranks are unique, gid = rank * K + ki).
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

import jax
import jax.numpy as jnp

from adlb_tpu.balancer import distributed as ref
from adlb_tpu_torch.balancer import auction, candidates
from adlb_tpu_torch.balancer import distributed as port
from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver

NEG = -(2**31) + 1
CLIP = 10**9

_ref_cands = jax.jit(ref._shard_candidates, static_argnums=(3, 4))


def _instance(seed, nshards, J, trunc, Sl=10, K=8):
    """A task table cut into shards, laid out as the solver keeps it (one
    [S, 2K + 1] table: prios, types, rank; the shards are strided views),
    plus requester tables. Truncated instances have D = C + m + 1 below the
    live slots of a type in a shard."""
    rng = np.random.default_rng(seed)
    T = 4 * J
    S = nshards * Sl
    tp = rng.integers(-9, 10, (S, K)).astype(np.int32)
    if J > 1:
        tp[rng.random((S, K)) < 0.15] = CLIP + 7000  # a job bias past the clip
        tp[rng.random((S, K)) < 0.1] = -CLIP - 3
    tt = rng.integers(-1, T, (S, K)).astype(np.int32)
    tp[rng.random((S, K)) < 0.15] = NEG
    rk = rng.permutation(S).astype(np.int32) + 3
    free = rng.random(S) < 0.2
    tp[free], tt[free], rk[free] = NEG, -1, 0
    m, rounds = (1, 4) if trunc else (4, 8)
    NR = S * 3
    C, D = port._slot_sizes(1 if trunc else None, m, rounds, NR)
    tab = torch.empty((S, 2 * K + 1), dtype=torch.int32)
    tab[:, :K], tab[:, K:2 * K] = torch.from_numpy(tp), torch.from_numpy(tt)
    tab[:, 2 * K] = torch.from_numpy(rk)
    views = (tab[:, :K].reshape(nshards, Sl, K),
             tab[:, K:2 * K].reshape(nshards, Sl, K),
             tab[:, 2 * K].reshape(nshards, Sl))
    rv = rng.random(NR) < 0.85
    rm = rng.random((NR, T)) < 0.4
    return dict(tp=tp, tt=tt, rk=rk, views=views, T=T, C=C, D=D, m=m,
                rounds=rounds, rm=rm, rv=rv, Sl=Sl, nshards=nshards)


def _jax_candidates(inst):
    """The JAX package's candidates, one shard at a time: [nshards, T, D]."""
    Sl, T, D = inst["Sl"], inst["T"], inst["D"]
    parts = []
    for d in range(inst["nshards"]):
        blk = slice(d * Sl, (d + 1) * Sl)
        parts.append(_ref_cands(jnp.asarray(inst["tp"][blk]),
                                jnp.asarray(inst["tt"][blk]),
                                jnp.asarray(inst["rk"][blk]), T, D))
    return (np.stack([np.asarray(p) for p, _ in parts]),
            np.stack([np.asarray(g) for _, g in parts]))


CASES = [(ns, J, trunc) for ns in (1, 2, 8) for J in (1, 2)
         for trunc in (False, True)]


@pytest.mark.parametrize("nshards,J,trunc", CASES)
def test_plain_candidates_equal_jax_shard_candidates(nshards, J, trunc):
    inst = _instance(10 * nshards + J + 100 * trunc, nshards, J, trunc)
    T, D = inst["T"], inst["D"]
    cp, cg = candidates.shard_candidates(*inst["views"], T, D)
    wp, wg = _jax_candidates(inst)
    assert cp.shape == (nshards, T, D) and cp.dtype == torch.int32
    assert np.array_equal(cp.numpy(), wp) and np.array_equal(cg.numpy(), wg)
    live = (inst["tp"] > NEG) & (inst["tt"] >= 0)
    per = [int((live[d * inst["Sl"]:(d + 1) * inst["Sl"]]
                & (inst["tt"][d * inst["Sl"]:(d + 1) * inst["Sl"]] == t))
               .sum()) for d in range(nshards) for t in range(T)]
    assert (max(per) > D) == trunc


@pytest.mark.parametrize("nshards,J,trunc", CASES)
def test_plain_merge_equals_first_d_columns_of_jax_merge(nshards, J, trunc):
    inst = _instance(20 * nshards + J + 100 * trunc, nshards, J, trunc)
    T, D = inst["T"], inst["D"]
    gp, gg = candidates.merged_candidates(*inst["views"], T, D)
    wp, wg = ref._merge_shard_major(*_jax_candidates(inst))
    assert gp.shape == (T, D) and gp.is_contiguous()
    assert np.array_equal(gp.numpy(), wp[:, :D])
    assert np.array_equal(gg.numpy(), wg[:, :D])
    if trunc and nshards > 1:
        # the cut drops live entries: [T, D] is not the whole merge
        assert ((wp > NEG).sum(axis=1) > D).any()


@pytest.mark.parametrize("nshards,J,trunc", CASES)
def test_auction_over_t_by_d_equals_jax_host_auction(nshards, J, trunc):
    inst = _instance(30 * nshards + J + 100 * trunc, nshards, J, trunc)
    T, C, D, m, rounds = (inst[k] for k in ("T", "C", "D", "m", "rounds"))
    gp, gg = candidates.merged_candidates(*inst["views"], T, D)
    rw, lens = ref._reqwin(inst["rm"], inst["rv"], T, C)
    rwc, open0 = port._compact_reqwin(rw)
    got = auction.auction(gp, gg, torch.from_numpy(rwc),
                          torch.from_numpy(lens), torch.from_numpy(open0),
                          rounds, m)
    wp, wg = ref._merge_shard_major(*_jax_candidates(inst))
    want = ref._host_auction(wp, wg, rw, lens, inst["rv"].copy(), rounds, m)
    assert np.array_equal(got.numpy()[:, :C], want)
    assert (got.numpy()[:, C] == -1).all() and (want >= 0).sum() > 0


@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_equal_pairs_make_the_candidates_independent_of_slot_order(nshards):
    """Slots that repeat a (prio, gid) pair (ranks repeated) give the same
    candidates whatever order the shard's rows are in, and the same as the
    JAX package's stable sort: which of two equal keys survives a cut does
    not show in the output."""
    rng = np.random.default_rng(40 + nshards)
    Sl, K, T, D = 8, 6, 3, 5
    S = nshards * Sl
    tp = rng.integers(0, 2, (S, K)).astype(np.int32)
    tt = rng.integers(0, T, (S, K)).astype(np.int32)
    rk = rng.integers(0, 3, S).astype(np.int32)  # many equal gids
    got = candidates.shard_candidates(
        torch.from_numpy(tp).view(nshards, Sl, K),
        torch.from_numpy(tt).view(nshards, Sl, K),
        torch.from_numpy(rk).view(nshards, Sl), T, D)
    perm = np.concatenate([d * Sl + rng.permutation(Sl)
                           for d in range(nshards)])
    shuffled = candidates.shard_candidates(
        torch.from_numpy(tp[perm]).view(nshards, Sl, K),
        torch.from_numpy(tt[perm]).view(nshards, Sl, K),
        torch.from_numpy(rk[perm]).view(nshards, Sl), T, D)
    inst = dict(tp=tp, tt=tt, rk=rk, Sl=Sl, T=T, D=D, nshards=nshards)
    want = _jax_candidates(inst)
    for g, s, w in zip(got, shuffled, want):
        assert torch.equal(g, s) and np.array_equal(g.numpy(), w)
    # the cut is binding and repeats a pair at its edge in some shard/type
    assert (got[0] > NEG).sum() == nshards * T * D


def test_solver_live_gids_are_unique_across_slot_reuse():
    """The solver's resident table never holds two live slots with one gid:
    ranks are unique per row, rows are free-listed (a freed row is dead
    before its next tenant arrives), and gid = rank * K + ki."""
    rng = np.random.default_rng(5)
    sol = DistributedAssignmentSolver((1, 2, 3), 4, 2, nshards=4,
                                      servers_per_shard=3, device="cpu")
    snaps = {}
    for rnd in range(12):
        for s in list(snaps):
            if rng.random() < 0.3:
                del snaps[s]  # a server leaves: its row is freed
        while len(snaps) < sol.S:
            s = int(rng.integers(100, 200))
            snaps[s] = {"tasks": [(int(rng.integers(1e6)), int(t), 1, 8)
                                  for t in rng.integers(1, 4, 4)],
                        "reqs": [(s * 10, rnd, None)]}
        sol.solve(snaps, None)
        tab = sol._dev_tab.numpy()
        K = sol.K
        live = (tab[:, :K] > NEG) & (tab[:, K:2 * K] >= 0)
        gids = (tab[:, 2 * K:2 * K + 1].astype(np.int64) * K
                + np.arange(K))[live]
        assert gids.size and np.unique(gids).size == gids.size, rnd


def test_device_plan_is_candidates_then_auction_on_the_cpu():
    """``_device_plan`` hands the auction the [T, D] merged candidates, and
    its commits equal the host tier's full-merge auction on the same
    state."""
    rng = np.random.default_rng(9)
    kw = dict(types=(1, 2, 3, 4), max_tasks_per_server=6, max_requesters=3,
              nshards=8, servers_per_shard=2, rounds=6, cand_width=3,
              slots_per_type=4, device="cpu")
    dev = DistributedAssignmentSolver(auction="device", **kw)
    host = DistributedAssignmentSolver(auction="host", **kw)
    snaps = {100 + s: {"tasks": [(s * 10 + i, int(rng.integers(1, 5)),
                                  int(rng.integers(-5, 5)), 8)
                                 for i in range(6)],
                       "reqs": [(s, 1, [int(rng.integers(1, 5))])]}
             for s in range(16)}
    assert dev.D == 4 + 3 + 1
    for sol in (dev, host):
        sol.ingest(snaps)
    a_dev = dev._device_plan()
    host._sweep()
    a_host = ref._host_auction(host._gp, host._gg, host._rw, host._lens,
                               host._req_valid.copy(), host.rounds, host.m)
    assert np.array_equal(a_dev, a_host) and (a_dev >= 0).sum() > 0
    # the merged candidates the auction took: [T, D]
    gp, _ = candidates.merged_candidates(*dev._dev_blocks, dev.T, dev.D)
    assert gp.shape == (dev.T, dev.D)
    assert ((host._gp > NEG).sum(axis=1) > dev.D).any()  # the cut binds


def test_candidates_check_their_inputs():
    tab = torch.zeros((8, 2 * 4 + 1), dtype=torch.int32)
    tp, tt = tab[:, :4].reshape(2, 4, 4), tab[:, 4:8].reshape(2, 4, 4)
    rk = tab[:, 8].reshape(2, 4)
    assert candidates.shard_candidates(tp, tt, rk, 2, 3)[0].shape == (2, 2, 3)
    with pytest.raises(ValueError, match="int32"):
        candidates.shard_candidates(tp.long(), tt, rk, 2, 3)
    with pytest.raises(ValueError, match="must be"):
        candidates.merged_candidates(tp, tt, rk[:, :3], 2, 3)
    with pytest.raises(ValueError, match="strided"):
        candidates.shard_candidates(tp.transpose(1, 2), tt, rk, 2, 3)
    with pytest.raises(ValueError, match="no candidates for device"):
        candidates.shard_candidates(tp.to("meta"), tt.to("meta"),
                                    rk.to("meta"), 2, 3)
