#!/usr/bin/env python
"""Kill the master of one soak world at each outbound frame in a range and
report which worlds end: the check for a finalize that dies with its
master (the promoted deputy must still see every rank finalize).

The world is the ported soak's seed 1362 master-kill world
(``scripts/chaos_soak_torch.py``): 3 apps x 4 servers spawned on the CPU,
planned with the host threshold 0, ``on_worker_failure="abort"``,
``on_server_failure="failover"``, 24 units put by rank 0, the master
SIGKILLed at its N-th outbound frame. A world that has not ended within
``--timeout`` seconds counts as hung. Every world that ends is checked for
conservation (each unit consumed, or counted in ``FAILOVER_LOST`` plus
``FAILOVER_RELAYS_UNRESOLVED``). Where the client acknowledges finalizes
(``Client._await_finalize_ack``), the ranks that re-sent theirs to the
promoted deputy are counted too (ranks fork, so the count is kept in a
file they append to).

Usage:
    python3 scripts/finalize_kill_sweep_torch.py [--frames 30:71]
        [--reps 1] [--seed 1362] [--timeout 20] [--root CHECKOUT]

``--root`` runs another checkout's package (for example the parent commit
unpacked with ``git archive``); ``--frames 48:49 --reps 24`` repeats one
frame.
"""

import argparse
import functools
import os
import struct
import sys
import tempfile
import time

T = 1


def economy(ctx, nunits):
    """Rank 0 puts ``nunits`` numbered units; every rank consumes until
    the world ends and returns the numbers it got."""
    from adlb_tpu_torch.types import ADLB_SUCCESS

    if ctx.rank == 0:
        for i in range(nunits):
            ctx.put(struct.pack("<q", i), T)
    got = []
    while True:
        rc, w = ctx.get_work([T])
        if rc != ADLB_SUCCESS:
            return got
        got.append(struct.unpack("<q", w.payload)[0])
        time.sleep(0.002)


def count_resends(path):
    """Wrap the client's finalize wait (where it exists) so each rank that
    re-sent its finalize after a takeover appends a line to ``path``."""
    from adlb_tpu_torch.runtime import client

    wait = getattr(client.Client, "_await_finalize_ack", None)
    if wait is None:
        return False

    def counted(self, fin):
        home = self._route(self.home)
        wait(self, fin)
        if self._route(self.home) != home:
            with open(path, "a") as f:
                f.write(f"{self.rank}\n")

    client.Client._await_finalize_ack = counted
    return True


def one_world(seed, frame, nunits, timeout):
    from adlb_tpu_torch.runtime.transport_tcp import spawn_world
    from adlb_tpu_torch.runtime.world import Config

    return spawn_world(
        3, 4, [T], functools.partial(economy, nunits=nunits),
        timeout=timeout, start_method="fork",
        cfg=Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                   exhaust_check_interval=0.2, on_worker_failure="abort",
                   on_server_failure="failover", failover_client_wait=30.0,
                   fault_spec={"seed": seed,
                               "kill_server_at_frame": {0: frame}}))


def conserved(res, nunits):
    from adlb_tpu_torch.types import InfoKey

    done = [x for v in res.app_results.values() for x in v]
    counted = sum(s.get(int(InfoKey.FAILOVER_LOST), 0.0)
                  + s.get(int(InfoKey.FAILOVER_RELAYS_UNRESOLVED), 0.0)
                  for s in res.server_stats.values())
    return len(set(range(nunits)) - set(done)) <= counted


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", default="30:71",
                    help="kill frames, start:stop (stop excluded)")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1362)
    ap.add_argument("--units", type=int, default=24)
    ap.add_argument("--timeout", type=float, default=20.0)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    # imported once here, so that every forked rank starts with them (a
    # rank that imports them itself starts seconds later, which moves
    # where in the world the kill lands)
    import adlb_tpu_torch.api  # noqa: F401
    import adlb_tpu_torch.balancer.engine  # noqa: F401
    import adlb_tpu_torch.runtime.server  # noqa: F401
    lo, hi = (int(x) for x in args.frames.split(":"))
    fd, marks = tempfile.mkstemp(suffix=".resends")
    os.close(fd)
    acked = count_resends(marks)
    hung, broken, killed, resent_at = [], [], 0, {}
    try:
        for frame in range(lo, hi):
            for rep in range(args.reps):
                before = os.path.getsize(marks)
                t0 = time.monotonic()
                try:
                    res = one_world(args.seed, frame, args.units,
                                    args.timeout)
                except Exception as e:  # noqa: BLE001 — a hang or a crash
                    hung.append(frame)
                    print(f"frame {frame} rep {rep}: did not end "
                          f"({type(e).__name__}) after "
                          f"{time.monotonic() - t0:.1f} s", flush=True)
                    continue
                ok = conserved(res, args.units) and not res.aborted
                if not ok:
                    broken.append(frame)
                killed += bool(res.server_casualties)
                with open(marks) as f:
                    f.seek(before)
                    resends = len(f.read().split())
                if resends:
                    resent_at[frame] = resent_at.get(frame, 0) + resends
                print(f"frame {frame} rep {rep}: ended in "
                      f"{time.monotonic() - t0:.2f} s, master killed "
                      f"{bool(res.server_casualties)}, conserved {ok}, "
                      f"finalizes re-sent {resends}", flush=True)
    finally:
        os.unlink(marks)
    worlds = (hi - lo) * args.reps
    print(f"SWEEP root={os.path.abspath(args.root)} seed={args.seed} "
          f"frames={lo}:{hi} reps={args.reps}: {worlds - len(hung)} of "
          f"{worlds} ended, {killed} with the master killed; did not end at "
          f"frames {hung}; not conserved or aborted at {broken}; "
          f"finalizes re-sent by frame "
          f"{resent_at if acked else 'not counted (no acknowledged finalize)'}")
    return 1 if hung or broken else 0


if __name__ == "__main__":
    raise SystemExit(main())
