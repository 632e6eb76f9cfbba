"""K4 (``candidates_kernel``: every shard's candidates and their merge) as
a share of its bytes bound: the bytes of its launches in the window over
the card's memory rate, against its device time in the trace."""

from benchmark.bounds import k4_bytes, roofline_pct
from benchmark.common import kernel_seconds


def read(run):
    tr = run.get("trace")
    if tr is None or run.get("kind") != "planner" or run.get("D") is None:
        return None
    sec, n = kernel_seconds(tr, "candidates_kernel")
    if n == 0:
        return None
    c = run["conf"]
    per = k4_bytes(run["table_rows"], c["max_tasks"], len(c["types"]),
                   run["D"])
    return roofline_pct(per * n, sec)
