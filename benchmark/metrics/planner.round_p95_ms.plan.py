"""The 95th percentile of the window's round times (host clock, ingest call
to returned pairs): the tail of the one planning loop."""

from benchmark.common import percentile


def read(run):
    r = run.get("rounds") if run.get("kind") == "planner" else None
    if not r or len(r) < 200:
        return None  # under ten rounds beyond the 95th percentile
    return percentile([1e3 * x[1] for x in r], 95)
