"""The churn traffic and the planner cell's pairs stay what they were: the
digests below were computed from the generator and the planner of the tree
before the generator was looked up by name (``Churn`` and
``planner_cell.build_solver`` called directly, by the same functions), and
the lookup must give the same bits from that tree's traffic file, whose
independent draws and fresh types are the generator's defaults. Both run a
fixed number of rounds, so no digest depends on the host's pace. The cell's
own traffic file now balances the mix and re-parks for the same type; what
that keeps fixed is checked at the end."""

import hashlib
from collections import Counter

import pytest

from benchmark import common, planner_cell
from benchmark.tests.test_bench_faults import SMALL_PLANNER

SEED = 2**31 + 11
#: sha256 of :func:`snapshot_digest` over 40 rounds, parent tree
CHURN_DIGEST = (
    "279134585dd6a69175f7f7a9f69b7153fdaa7733c9ce2690200679a96cc018b5")
#: sha256 of :func:`pairs_digest` over 20 rounds, parent tree
PAIRS_DIGEST = (
    "b6854b990ebfff43e47bab7adadac4ab340bcb11394f4ef7c71d75d2cb3a2c15")
#: ``traffic/churn.json`` of the tree the digests were computed on
PARENT_CHURN = {"kind": "planner", "first_rank": 100, "delta_servers": 8,
                "burst": 16, "prio_range": [-50, 50], "warm_rounds": 8,
                "check_most": 64, "check_tail_s": 0.1}


def small_cell(traffic=PARENT_CHURN):
    """The churn cell's configuration at the small size, and a churn
    traffic (by default the parent's)."""
    manifest = common.load_manifest()
    cell = next(w for w in manifest["workloads"] if w["traffic"] == "churn")
    _, entry = common.find_cell(manifest, cell["name"])
    return ({**common.config_file(entry), **SMALL_PLANNER}, traffic)


def first_fit(gen, most=12):
    """A fixed consume rule: the holders in rank order, each task in queue
    order, paired with the first requester (servers in rank order, each
    list in order) that accepts its type and has no pair yet; at most
    ``most`` pairs."""
    pairs, taken = [], set()
    for holder in sorted(gen.holding):
        for seqno, ty, _prio, _len in gen.snaps[holder]["tasks"]:
            if len(pairs) == most:
                return pairs
            for home in gen.order:
                hit = next(((home, r[0], r[1]) for r in gen.snaps[home]["reqs"]
                            if (r[2] is None or ty in r[2])
                            and (r[0], r[1]) not in taken), None)
                if hit is not None:
                    taken.add(hit[1:])
                    pairs.append((holder, seqno) + hit)
                    break
    return pairs


def snapshot_digest(Gen, rounds=40):
    """Every round's snapshots, holders and frozen copy, after ``rounds``
    rounds of bursts consumed by :func:`first_fit`."""
    conf, traffic = small_cell()
    gen = Gen(traffic, conf["servers"], conf["max_tasks"],
              conf["max_requesters"], conf["types"], SEED)
    h = hashlib.sha256(repr(sorted(gen.snaps.items())).encode())
    for _ in range(rounds):
        gen.bursts()
        h.update(repr(sorted(gen.frozen(8).items())).encode())
        gen.consume(first_fit(gen))
        h.update(repr(sorted(gen.snaps.items())).encode())
        h.update(repr(sorted(gen.holding)).encode())
    return h.hexdigest()


def pairs_digest(Gen, rounds=20):
    """The pairs of the program's planner on the CPU, driven as the cell
    drives it: the cold ingest and plan, then ``rounds`` rounds."""
    conf, traffic = small_cell()
    gen = Gen(traffic, conf["servers"], conf["max_tasks"],
              conf["max_requesters"], conf["types"], SEED)
    solver = planner_cell.build_solver(conf, "cpu")
    solver.ingest(gen.snaps)
    h = hashlib.sha256(repr(solver.plan()).encode())
    for _ in range(rounds):
        gen.bursts()
        solver.ingest(gen.snaps)
        pairs = solver.plan()
        h.update(repr(pairs).encode())
        gen.consume(pairs)
    return h.hexdigest()


def test_churn_snapshots_are_the_parents():
    _, traffic = small_cell()
    assert snapshot_digest(planner_cell.generator(traffic)) == CHURN_DIGEST


def test_churn_cell_pairs_are_the_parents():
    _, traffic = small_cell()
    assert pairs_digest(planner_cell.generator(traffic)) == PAIRS_DIGEST


@pytest.mark.parametrize("seed", [SEED, 2**32 + 7])
def test_cell_churn_keeps_each_servers_mix_and_each_rounds_tasks(seed):
    """Under the cell's traffic (balanced, re-parked for the same type),
    driven by the program's planner on the CPU: every burst holds each type
    equally often, every server keeps its cold pool's mix of types, and
    every round plans the same number of pairs of each type."""
    conf, traffic = small_cell(common.traffic_file("churn"))
    assert traffic["mix"] == "balanced" and traffic["repark"] == "same"
    T, R = len(conf["types"]), conf["max_requesters"]
    gen = planner_cell.generator(traffic)(
        traffic, conf["servers"], conf["max_tasks"], R, conf["types"], seed)

    def mixes():
        return {s: Counter(r[2][0] for r in v["reqs"])
                for s, v in gen.snaps.items()}

    cold = mixes()
    assert all(m == Counter({t: R // T for t in conf["types"]})
               for m in cold.values())
    solver = planner_cell.build_solver(conf, "cpu")
    per_round = set()
    for _ in range(30):
        seq = gen.seq
        gen.bursts()
        new = [t for v in gen.snaps.values() for t in v["tasks"]
               if t[0] >= seq]
        assert Counter(t[1] for t in new) == Counter(
            {t: traffic["delta_servers"] * traffic["burst"] // T
             for t in conf["types"]})
        solver.ingest(gen.snaps)
        pairs = solver.plan()
        kind = {(h, q): ty for h, v in gen.snaps.items()
                for q, ty, _p, _l in v["tasks"]}
        per_round.add(tuple(sorted(Counter(
            kind[(h, q)] for h, q, *_ in pairs).items())))
        gen.consume(pairs)
        assert mixes() == cold
    assert len(per_round) == 1
