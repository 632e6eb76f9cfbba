"""K5 (``auction_kernel``) as a share of its bytes bound. Each launch's
bytes are its rounds', from that round's commits per type (the requester
tables taken full: at the cell's scale every type has more parked
requesters than C), and its prologue's, from the program's spans: the rows
each ingest staged (``planner:ingest.reqrows``) packed, and the rows each
plan scanned (``planner:plan.readback``) into its windows. Their mean a
launch times the launches in the trace, against the kernel's device
time."""

from benchmark.bounds import (k5_bytes, k5_pack_bytes, k5_window_bytes,
                              roofline_pct)
from benchmark.common import kernel_seconds, program_spans


def read(run):
    tr = run.get("trace")
    plans = program_spans(run, "planner:plan.readback")
    if tr is None or plans is None or run.get("C") is None:
        return None
    sec, n = kernel_seconds(tr, "auction_kernel")
    C, c = run["C"], run["conf"]
    R, T = c["max_requesters"], len(c["types"])
    rounds = [k5_bytes(x[6].tolist(), [C] * T, c["cand_width"], run["D"], C)
              for x in run["rounds"] if len(x) > 6 and x[6] is not None]
    if n == 0 or not rounds:
        return None
    prologue = sum(k5_window_bytes(a["scanned"], R, T, C) for _, a in plans)
    prologue += sum(k5_pack_bytes(a["rows"], R, T) for _, a in
                    program_spans(run, "planner:ingest.reqrows") or ())
    return roofline_pct((sum(rounds) / len(rounds) + prologue / len(plans))
                        * n, sec)
