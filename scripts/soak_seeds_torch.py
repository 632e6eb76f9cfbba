"""Runs chosen seeds of the port's chaos soak
(``scripts/chaos_soak_torch.py``), each a given number of times, and
prints one line per iteration:

    SOAKSEED <seed> <rep> ok|FAIL <wall s> <drawn world or error> <planners>

where ``<planners>`` maps each planning rank of the iteration's spawned
worlds to (device solves, greedy-sweep launches, kept solves checked
against ``_host_greedy``, kept solves found wrong). Every device solve is
kept and checked (``ADLB_CHECK_SOLVES=1``); a SIGKILLed master reports
nothing; set ADLB_FLIGHT_DIR to keep flight records. Run it from the
repository root:

    python3 scripts/soak_seeds_torch.py [--device cuda|cpu] SEED:REPS ...
"""

import os
import sys
import time
import traceback


def main(argv) -> int:
    device = "cuda"
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    os.environ["ADLB_CHECK_SOLVES"] = "1"
    sys.path[:0] = [os.getcwd(), os.path.dirname(os.path.abspath(__file__))]
    from adlb_tpu_torch.balancer import solve

    import chaos_soak_torch as soak

    solve.check_every = 1
    failed = 0
    for arg in argv:
        seed, reps = map(int, arg.split(":"))
        for rep in range(reps):
            soak.PLANNERS.clear()
            t0 = time.perf_counter()
            try:
                desc, ok = soak.one_iter(seed, device=device), "ok"
            except BaseException as e:  # noqa: BLE001 — reported, counted
                desc, ok = (f"{e!r} || " + traceback.format_exc()[-1500:]
                            .replace("\n", " | ")), "FAIL"
                failed += 1
            planners = {r: (c["device_solves"], c["greedy_sweep_launches"],
                            c["solves_checked"], c["solves_wrong"])
                        for p in soak.PLANNERS for r, c in p.items()}
            print("SOAKSEED", seed, rep, ok,
                  round(time.perf_counter() - t0, 3), desc, planners,
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
