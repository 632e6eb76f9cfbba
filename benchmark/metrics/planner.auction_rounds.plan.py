"""Auction rounds K5 ran a plan (the count ``rounds`` of span
``planner:plan.readback``: up to the first round that committed nothing,
or the configured most), the mean over the window's plans. None where the
readback reports no rounds (a program that does not count them)."""

from benchmark.common import program_spans


def read(run):
    found = program_spans(run, "planner:plan.readback")
    if found is None or any(a.get("rounds") is None for _, a in found):
        return None
    return sum(a["rounds"] for _, a in found) / len(found)
