"""The PyTorch port's copy of ``scripts/parity_profile.py``: its imports
rewritten to ``adlb_tpu_torch``, and its planned (``balancer="tpu"``)
worlds on ``--device`` (``cuda``, the default, or ``cpu``).

Dogfood the continuous profiler on the tpu-vs-steal parity of tsp and
gfmc, which an earlier probe showed is NOT codec-bound. Run the SAME
workloads the parity rows measure with ``profile_hz=19`` armed, capture
the per-(role, phase) sample attribution for each balancer mode, and
diff them — the phases that grow under "tpu" but not "steal" ARE the
residual, named by the profiler instead of guessed at.

Method: tsp/gfmc ride run_world (one process, thread ranks), so the
first server to call ``profile.start`` owns the single per-process
sampler and every rank's threads land in it role-tagged. A watcher
thread grabs the active Profiler handle mid-run; its cumulative
``counts`` survive the stop, so each rep contributes a full-run fold.
Samples aggregate over reps per mode (sampling noise at 19 Hz needs
the depth), normalized to SHARES before diffing so mode runtime
differences cancel.

Usage: python scripts/parity_profile_torch.py [--device cuda|cpu] [reps]

Writes nothing; prints the attribution table (the docs/
PARITY_PROFILE.md verdict is the curated output of a run of this).
"""
import os
import re
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from adlb_tpu_torch.obs import profile  # noqa: E402
from adlb_tpu_torch.runtime.world import Config  # noqa: E402
from adlb_tpu_torch.workloads import gfmc, tsp  # noqa: E402

APPS, SERVERS = 6, 3  # the parity rows' shape (bench.py)


#: where the planned worlds solve (``main`` sets it from ``--device``)
DEVICE = {"device": "cuda"}


def cfg(mode: str) -> Config:
    kw = dict(exhaust_check_interval=0.2, profile_hz=19.0, **DEVICE)
    if mode == "steal":
        # upstream-faithful baseline, as in the bench parity rows
        return Config(balancer="steal", qmstat_mode="ring",
                      qmstat_interval=0.1, **kw)
    return Config(balancer="tpu", balancer_max_tasks=256,
                  balancer_max_requesters=64, **kw)


def one_rep(workload: str, mode: str) -> tuple:
    """One workload run; returns (tasks_per_sec, folded counts)."""
    grabbed: dict = {}
    stop = threading.Event()

    def watch():
        # the sampler only exists while the world runs: grab the handle
        # mid-run; its cumulative counts survive the stop
        while not stop.is_set():
            p = profile.active()
            if p is not None:
                grabbed["p"] = p
            time.sleep(0.05)

    w = threading.Thread(target=watch, daemon=True)
    w.start()
    try:
        if workload == "tsp":
            r = tsp.run(n_cities=10, num_app_ranks=APPS, nservers=SERVERS,
                        seed=3, cfg=cfg(mode), timeout=600.0)
        else:
            r = gfmc.run(num_a=400, bs_per_a=8, cs_per_b=5,
                         num_app_ranks=APPS, nservers=SERVERS,
                         cfg=cfg(mode), timeout=600.0)
    finally:
        stop.set()
        w.join()
    p = grabbed.get("p")
    counts = dict(p.counts) if p is not None else {}
    rate = r.tasks_processed / r.elapsed if r.elapsed else 0.0
    return rate, counts


def bucket(stack: str) -> str:
    """role[;phase] — the attribution grain. Balancer-owned phases keep
    their name; handler phases collapse to the tag family so 19 Hz
    sampling depth concentrates instead of scattering."""
    parts = stack.split(";")
    role = parts[0]
    phase = ""
    if len(parts) > 1 and parts[1].startswith("phase:"):
        phase = parts[1][len("phase:"):]
        phase = re.sub(r"^handler:.*", "handler", phase)
    return f"{role};{phase}" if phase else role


def run_mode(workload: str, mode: str, reps: int) -> tuple:
    rates, agg = [], {}
    for _ in range(reps):
        rate, counts = one_rep(workload, mode)
        rates.append(rate)
        for stack, n in counts.items():
            b = bucket(stack)
            agg[b] = agg.get(b, 0) + n
    rates.sort()
    return rates[len(rates) // 2], agg


def shares(agg: dict) -> dict:
    total = sum(agg.values()) or 1
    return {k: v / total for k, v in agg.items()}


def main() -> None:
    args = sys.argv[1:]
    if "--device" in args:
        i = args.index("--device")
        DEVICE["device"] = args[i + 1]
        assert DEVICE["device"] in ("cuda", "cpu"), DEVICE
        del args[i:i + 2]
    reps = int(args[0]) if args else 3
    for workload in ("tsp", "gfmc"):
        out = {}
        for mode in ("steal", "tpu"):
            out[mode] = run_mode(workload, mode, reps)
        r_s, a_s = out["steal"]
        r_t, a_t = out["tpu"]
        sh_s, sh_t = shares(a_s), shares(a_t)
        ratio = r_t / r_s if r_s else 0.0
        print(f"\n== {workload}: steal {r_s:.0f}/s  tpu {r_t:.0f}/s  "
              f"ratio {ratio:.3f}  "
              f"(samples steal={sum(a_s.values())} tpu={sum(a_t.values())})")
        keys = sorted(set(sh_s) | set(sh_t),
                      key=lambda k: sh_t.get(k, 0) - sh_s.get(k, 0),
                      reverse=True)
        print(f"   {'bucket':44s} {'steal%':>7s} {'tpu%':>7s} {'delta':>7s}")
        for k in keys:
            s, t = sh_s.get(k, 0) * 100, sh_t.get(k, 0) * 100
            if max(s, t) < 0.5:
                continue
            print(f"   {k:44s} {s:6.1f}% {t:6.1f}% {t - s:+6.1f}%")


if __name__ == "__main__":
    main()
