"""Requester rows the device plan's windows took in, a round (the count
``scanned`` of span ``planner:plan.readback``: rows in rank order up to
the one that filled the last type's window of C), over the window's
rounds."""

from benchmark.common import program_spans


def read(run):
    found = program_spans(run, "planner:plan.readback")
    if found is None or not run.get("rounds"):
        return None
    return sum(a["scanned"] for _, a in found) / len(run["rounds"])
