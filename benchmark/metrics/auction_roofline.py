"""K5 (``auction_kernel``) as a share of its bytes bound: each window
round's bytes from its own commits per type (the requester tables taken
full: at the cell's scale every type has more parked requesters than C),
their mean times the launches in the trace, against their device time."""

from benchmark.bounds import k5_bytes, roofline_pct
from benchmark.common import kernel_seconds


def read(run):
    tr = run.get("trace")
    if tr is None or run.get("kind") != "planner" or run.get("C") is None:
        return None
    sec, n = kernel_seconds(tr, "auction_kernel")
    per = [k5_bytes(x[6].tolist(), [run["C"]] * len(x[6]),
                    run["conf"]["cand_width"], run["D"], run["C"])
           for x in run["rounds"] if len(x) > 6 and x[6] is not None]
    if n == 0 or not per:
        return None
    return roofline_pct(sum(per) / len(per) * n, sec)
