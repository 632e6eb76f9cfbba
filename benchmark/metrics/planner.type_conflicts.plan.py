"""Entries of K5's rounds that lost their requester to another type's
candidate, summed over a plan's rounds (the count ``lost`` of span
``planner:plan.readback``), the mean over the window's plans. None where
the readback reports no such count (a program that does not count it)."""

from benchmark.common import program_spans


def read(run):
    found = program_spans(run, "planner:plan.readback")
    if found is None or any(a.get("lost") is None for _, a in found):
        return None
    return sum(a["lost"] for _, a in found) / len(found)
