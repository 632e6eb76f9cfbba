"""A planner cell: the sharded planner (``DistributedAssignmentSolver``)
driven in a closed loop, one round after another, by a traffic generator.

A round runs from the call of ``ingest`` to the pairs that ``plan`` returns;
the harness's own data plane between rounds (bursts, the plan consumed,
requesters re-parked, the copies kept for the check) lies outside it.
End to end, ``plan_device_us`` is the card's busy time over the window
over its rounds, from a device trace of the window in every run on the
card; the rounds' summed host time over their number is the per-layer
``planner.round_ms.plan``.

The generator is named by the traffic file's ``"generator": G`` (``churn``
where it names none): the module ``benchmark/<G>.py``, whose
``Generator(params, nservers, K, R, types, seed)`` takes the traffic file's
parameters and the configuration's sizes and draws everything from
``seed``. It provides

* ``snaps``: the servers' snapshots, ``{rank: {"tasks": [(seqno, type,
  prio, length), ...], "reqs": [(rank, rqseqno, types or None), ...],
  "stamp": s, "task_stamp": s}}``, what ``ingest`` takes;
* ``bursts()``: the round's new work, into ``snaps``;
* ``consume(pairs)``: the data plane takes the round's plan;
* ``frozen(C)``: a copy of the snapshots as far as a round's plan can read
  them with C requesters a type in view, for the check.

So a new traffic shape is a new generator file and a traffic file, with no
edit here.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import reference
from benchmark.common import Spans, harness_module


def generator(traffic: dict):
    """The traffic's generator class (see above)."""
    return harness_module(traffic.get("generator", "churn")).Generator


def build_solver(conf: dict, device: str):
    from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver

    S, ns = conf["servers"], conf["nshards"]
    return DistributedAssignmentSolver(
        conf["types"], conf["max_tasks"], conf["max_requesters"],
        nshards=ns, rounds=conf["auction_rounds"],
        servers_per_shard=-(-S // ns), cand_width=conf["cand_width"],
        auction=conf["auction"], device=device)


class ControlPlanner:
    """The reference in the planner's place, with the priorities coarsened
    (``prio >> shift``): the control, which must come out not correct."""

    def __init__(self, conf: dict, shift: int) -> None:
        self.conf, self.shift = conf, shift
        self.last_ingest_ms = self.last_solve_ms = self.last_extract_ms = 0.0
        self.last_assigned = None
        self._snaps = None

    def ingest(self, snaps: dict) -> int:
        self._snaps = {s: {"tasks": v["tasks"], "reqs": v["reqs"]}
                       for s, v in snaps.items()}
        return 0

    def plan(self) -> list:
        c = self.conf
        pairs, self.last_assigned = reference.plan_from_snapshots(
            self._snaps, c["types"], c["max_tasks"], c["max_requesters"],
            c["servers"], c["auction_rounds"], c["cand_width"], self.shift)
        return pairs


def control(shift: int) -> dict:
    """The run's hooks that put the control in the program's place: the
    reference planner, priorities coarsened by ``shift`` bits."""
    return {"make_solver": lambda conf: ControlPlanner(conf, shift)}


def run(conf: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", make_solver=None,
        log=print) -> dict:
    """One run of the cell. ``make_solver(conf)`` replaces the program's
    solver (the control, or a test's broken one). Returns the run's record
    for the result line and the readers."""
    import torch

    spans = Spans(trace)
    t = time.perf_counter()
    solver = (make_solver or (lambda c: build_solver(c, device)))(conf)
    if hasattr(solver, "warm"):
        solver.warm()
    t_gen = time.perf_counter()
    gen = generator(traffic)(traffic, conf["servers"], conf["max_tasks"],
                             conf["max_requesters"], conf["types"], seed)
    t_cold = time.perf_counter()
    log(f"set-up: {t - t_process:.3f} s to the solver, its build "
        f"{t_gen - t:.3f} s, the cold pool {t_cold - t_gen:.3f} s")
    t = time.perf_counter()
    solver.ingest(gen.snaps)
    solver.plan()
    cold_ms = (time.perf_counter() - t) * 1e3
    for _ in range(int(traffic["warm_rounds"])):
        gen.bursts()
        solver.ingest(gen.snaps)
        gen.consume(solver.plan())
    if device == "cuda":
        torch.cuda.synchronize()
    # the 1,000,000 parked requesters are the harness's and the solver's
    # long-lived heap: moved out of the collector's reach, so a full
    # collection over them does not land in a round at random
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    log(f"set-up: cold ingest + plan {cold_ms:.1f} ms, "
        f"{traffic['warm_rounds']} warm rounds, collection "
        f"{time.perf_counter() - t:.3f} s")
    C_ref = reference.slot_sizes(conf["cand_width"], conf["auction_rounds"],
                                 conf["servers"] * conf["max_requesters"])[0]
    # the rounds checked: a uniform sample of the window's rounds drawn
    # from the seed (a reservoir of ``check_most``, so the end of the window
    # counts as much as its start), and the window's last round
    check_rng = np.random.default_rng([seed % (1 << 63), 1])
    most = int(traffic["check_most"])
    tail_s = float(traffic["check_tail_s"])
    checks: list = []
    last = None
    rounds: list = []
    profiler = planner_trace = None
    t_prof = time.perf_counter()
    if trace or device == "cuda":
        # the card's busy time a round (``plan_device_us``) in every run
        # on the card; traced runs add the host's spans and name the gaps
        from benchmark.common import DeviceTrace
        import tempfile

        profiler = DeviceTrace(tempfile.gettempdir(), host=trace)
        if trace and hasattr(solver, "tracer"):
            # the planner's own phase spans, on time.perf_counter as the
            # harness's spans and the profiler's clock mark are
            from adlb_tpu_torch.runtime.trace import PID_SERVER, Tracer

            planner_trace = solver.tracer = Tracer(0, PID_SERVER)
        profiler.start()
    gc_before = [g["collections"] for g in gc.get_stats()]
    t_window = time.perf_counter()
    # the profiler's start (CUPTI's, 7-9 s on the card) is the yardstick's
    # and not the program's: set-up leaves it out
    prof_s = t_window - t_prof
    setup_s = t_window - t_process - prof_s
    t_end = t_window + seconds
    while True:
        t_dp = time.perf_counter()
        if t_dp >= t_end:
            break
        gen.bursts()
        i = len(rounds)
        slot = i if i < most else int(check_rng.integers(0, i + 1))
        sample, final = slot < most, t_dp >= t_end - tail_s
        frozen = gen.frozen(C_ref) if sample or final else None
        t0 = time.perf_counter()
        spans.span("data_plane (benchmark)", t_dp, t0)
        solver.ingest(gen.snaps)
        t1 = time.perf_counter()
        pairs = solver.plan()
        t2 = time.perf_counter()
        spans.span("ingest", t0, t1)
        spans.span("plan", t1, t2)
        rec = [t0, t2 - t0, solver.last_ingest_ms, solver.last_solve_ms,
               solver.last_extract_ms, len(pairs)]
        if trace:
            asg = solver.last_assigned
            rec.append(None if asg is None else (asg >= 0).sum(axis=1))
        rounds.append(rec)
        if sample or final:
            asg = solver.last_assigned
            item = (i, frozen, list(pairs),
                    None if asg is None else np.array(asg))
            if sample:
                if i < most:
                    checks.append(item)
                else:
                    checks[slot] = item
            if final:
                last = item
        t3 = time.perf_counter()
        gen.consume(pairs)
        spans.span("data_plane (benchmark)", t3, time.perf_counter())
    t_closed = time.perf_counter()
    gc_stats = [g["collections"] for g in gc.get_stats()]
    trace_out = program_spans = busy = None
    if profiler is not None:
        profiler.stop()
        if planner_trace is not None:
            solver.tracer = None
            program_spans = window_spans(planner_trace.events, t_window,
                                         t_closed)
        if trace:
            labels = spans.items + [sp[:3] for sp in program_spans or ()]
            trace_out = profiler.reduce(labels, t_window, t_closed)
        else:
            busy = profiler.busy()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    nshards_rows = getattr(solver, "S", conf["servers"])
    C = getattr(solver, "C", None)
    D = getattr(solver, "D", None)
    del solver
    if device == "cuda":
        torch.cuda.empty_cache()
    if last is not None and all(c[0] != last[0] for c in checks):
        checks.append(last)
    checks.sort(key=lambda c: c[0])
    t_ref = time.perf_counter()
    wrong, details = 0, []
    for i, frozen, pairs, asg in checks:
        ref_pairs, ref_asg = reference.plan_from_snapshots(
            frozen, conf["types"], conf["max_tasks"], conf["max_requesters"],
            conf["servers"], conf["auction_rounds"], conf["cand_width"])
        bad = pairs != ref_pairs or (ref_asg is not None and (
            asg is None or asg.shape != ref_asg.shape
            or not np.array_equal(asg, ref_asg)))
        if bad:
            wrong += 1
            if len(details) < 3:
                details.append(f"round {i} of the window: {len(pairs)} "
                               f"pairs, reference {len(ref_pairs)}")
    ref_s = time.perf_counter() - t_ref
    for d in details:
        log(d)
    if checks:
        log(f"rounds checked: {len(checks)} of {len(rounds)}, from round "
            f"{checks[0][0]} to round {checks[-1][0]}")
    fifths = [[] for _ in range(5)]
    for r in rounds:
        fifths[min(int(5 * (r[0] - t_window) / seconds), 4)].append(r[1])
    log(f"the profiler's start {prof_s:.3f} s, left out of set-up; the "
        f"card's busy time " + ("not read" if busy is None else
                                f"{busy['busy_s']:.6f} s in {busy['ops']} "
                                f"operations"))
    log("rounds by fifth of the window: " + ", ".join(
        f"{1e3 * sum(f) / len(f):.2f} ms ({len(f)})" for f in fifths if f)
        + f"; collections in the window by generation "
        f"{[a - b for a, b in zip(gc_stats, gc_before)]}")
    return {"kind": "planner", "setup_s": setup_s, "cold_ms": cold_ms,
            "seconds": seconds, "window_s": t_closed - t_window,
            "rounds": rounds, "checked": len(checks),
            "checked_rounds": [c[0] for c in checks], "rounds_wrong": wrong,
            "reference_s": ref_s, "memory_peak_bytes": peak,
            "trace": trace_out, "program_spans": program_spans,
            "device_busy": busy,
            "conf": conf, "table_rows": nshards_rows, "C": C, "D": D}


def window_spans(events: list, lo: float, hi: float) -> list:
    """The program's trace events that lie in the window [lo, hi]
    (``time.perf_counter`` seconds) as (name, start, end, args), in
    seconds."""
    out = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        t0 = ev["ts"] * 1e-6
        t1 = t0 + ev["dur"] * 1e-6
        if lo <= t0 and t1 <= hi:
            out.append((ev["name"], t0, t1, ev.get("args", {})))
    return out


def end_to_end(run: dict) -> dict:
    """The card's busy time a planning round, in microseconds: the union of
    its operations' intervals over the window (an untraced run's device
    trace) over the window's rounds."""
    r, busy = run["rounds"], run.get("device_busy")
    return {"plan_device_us": 1e6 * busy["busy_s"] / len(r)
            if r and busy else None}


def counts(run: dict) -> tuple:
    """(attempted, failed): rounds run and checked rounds wrong."""
    return len(run["rounds"]), run["rounds_wrong"]


def summary(run: dict) -> str:
    r = run["rounds"]
    mean = 1e3 * sum(x[1] for x in r) / len(r) if r else float("nan")
    return (f"{len(r)} rounds of {mean:.4f} ms, cold ingest + plan "
            f"{run['cold_ms']:.1f} ms, {run['checked']} checked")


def compared(run: dict) -> dict:
    """The numbers that decide ``correct``: (value, limit, rule)."""
    return {"rounds_wrong": (run["rounds_wrong"], 0, "<="),
            "rounds_checked": (run["checked"], 8, ">=")}
