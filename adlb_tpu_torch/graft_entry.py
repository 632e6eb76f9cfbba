"""The port's graft entry points, the counterparts of the JAX package's
``__graft_entry__.py``:

* :func:`entry` — the planned balancer's greedy assignment solve (one launch
  of ``csrc/greedy_sweep.cu`` on the card, its plain version on the CPU) at
  the JAX entry's shape: 8 servers x 128 task slots, 32 requesters each, 4
  types, about 20% padding slots, seed 0;
* :func:`dryrun_multichip` — the sharded planner over ``n`` shards, one per
  card (the JAX entry builds an ``n``-device mesh): a solve whose pairs
  respect every requester's type mask, then an engine round that plans both
  matches and migrations. It uses the first ``n`` cards; with fewer visible
  the shards go round-robin over them, as the JAX entry provisions virtual
  devices (``_provision_virtual_devices``). Each device plan is one launch
  of ``csrc/candidates.cu`` on each shard's card, the lists gathered onto
  the first card, one launch of the merge alone and one of
  ``csrc/auction.cu`` there. On the CPU the ``n`` shards are logical.

Both run on the card unless the caller asks for ``device="cpu"``; without a
card ``device="cuda"`` raises.

    python -m adlb_tpu_torch.graft_entry [--device cuda|cpu] [--n 8]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def entry(device: str = "cuda"):
    """Returns (fn, example_args): ``fn(*args)`` is the greedy solve,
    ``assign [NR]`` int32 of task indices (-1 = none), its inputs on
    ``device``."""
    import torch

    from adlb_tpu_torch.balancer import greedy_sweep
    from adlb_tpu_torch.balancer.solve import _NEG, check_device

    dev = check_device(device)
    S, K, R, T = 8, 128, 32, 4
    rng = np.random.default_rng(0)
    NT, NR = S * K, S * R
    task_prio = rng.integers(-100, 100, size=(NT,)).astype(np.int32)
    task_type = rng.integers(0, T, size=(NT,)).astype(np.int32)
    pad = rng.random(NT) < 0.2  # ~20% padding slots
    task_prio[pad] = int(_NEG)
    task_type[pad] = -1
    req_mask = rng.random((NR, T)) < 0.5
    req_valid = rng.random(NR) < 0.8
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (task_prio, task_type, req_mask, req_valid))
    return greedy_sweep.greedy_assign, args


def card_placement(n: int) -> list:
    """The cards of ``n`` shards: the first ``n`` visible, round-robin over
    them when fewer are visible."""
    import torch

    from adlb_tpu_torch.balancer.solve import check_device

    check_device("cuda")
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One sharded planning step over ``n_devices`` shards, one per card (on
    ``"cpu"``, logical shards), with the JAX entry's assertions: the solve
    plans pairs, every pair respects its requester's type mask, and a
    ``PlanEngine(use_mesh=True)`` round over the same placement plans both
    matches and migrations. Returns what it planned, the cards visible and
    the placement (None for logical shards)."""
    import torch

    from adlb_tpu_torch.balancer.distributed import (
        DistributedAssignmentSolver)
    from adlb_tpu_torch.balancer.engine import PlanEngine

    placement = (card_placement(n_devices)
                 if torch.device(device).type == "cuda" else None)
    types = (1, 2)
    solver = DistributedAssignmentSolver(
        types=types, max_tasks_per_server=8, max_requesters=4,
        nshards=n_devices, device=device, devices=placement)
    # tiny but non-trivial state: one task and one requester per server
    snapshots = {}
    for s in range(n_devices):
        snapshots[100 + s] = {
            "tasks": [(s + 1, types[s % 2], 10 - s, 8)],
            "reqs": [((s + 1) % n_devices, s + 1, [types[(s + 1) % 2]])],
        }
    pairs = solver.solve(snapshots, None)
    assert pairs, "distributed solve produced no assignments"
    # every assignment must respect the requester's type mask
    task_types = {
        (s, t[0]): t[1] for s, snap in snapshots.items() for t in snap["tasks"]
    }
    for holder, seqno, req_home, for_rank, rqseqno in pairs:
        wanted = types[(req_home - 100 + 1) % 2]
        assert task_types[(holder, seqno)] == wanted
    # and the full balancer round (solve + fair-share migration planning)
    # through the engine over the same shards
    engine = PlanEngine(
        types=types, max_tasks=8, max_requesters=4, use_mesh=True,
        nshards=n_devices, nservers=n_devices, device=device,
        devices=placement)
    assert isinstance(engine.solver, DistributedAssignmentSolver)
    # One hot server holds the whole backlog; two remote servers have
    # parked requesters (demand-driven matches) and the rest are consumers
    # whose fair share must be migrated ahead of demand. The backlog stays
    # >= the consumer count after the solve plans matches away, or the
    # engine's scarcity guard (correctly) skips migration planning.
    hot = {100: {"tasks": [(i + 1, types[i % 2], i, 8) for i in range(8)],
                 "reqs": [], "nbytes": 64, "consumers": 0}}
    for s in range(1, n_devices):
        reqs = [(s, 1, None)] if s <= 2 else []
        hot[100 + s] = {"tasks": [], "reqs": reqs,
                        "nbytes": 0, "consumers": 0 if s <= 2 else 1}
    matches, migrations = engine.round(hot, None)
    assert matches, "engine round planned no matches"
    assert migrations, "engine round planned no migrations"
    return {"pairs": len(pairs), "matches": len(matches),
            "migrations": len(migrations),
            "device_plans": solver.solve_count + engine.solver.solve_count,
            "cards_visible": torch.cuda.device_count(),
            "placement": (None if placement is None
                          else [str(d) for d in placement])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--n", type=int, default=8,
                    help="shards (one per card, logical on the CPU)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print(f"entry() solve: {tuple(out.shape)} assignments: "
          f"{int((out >= 0).sum())}")
    got = dryrun_multichip(args.n, args.device)
    where = (f"{args.n} logical shards on {args.device}"
             if got["placement"] is None else
             f"{args.n} shards over {got['cards_visible']} visible cards "
             f"{json.dumps({k: got[k] for k in ('cards_visible', 'placement')})}")
    print(f"dryrun_multichip: {where}, {got['pairs']} plan entries, types "
          f"respected; engine round: {got['matches']} matches, "
          f"{got['migrations']} migrations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
