"""The diff walk's useful share: the servers whose snapshot changed over
the servers it walked, summed over the window's rounds (span
``planner:ingest.diff``, its counts ``servers_changed`` and ``walked``),
in %."""

from benchmark.common import program_spans


def read(run):
    found = program_spans(run, "planner:ingest.diff")
    walked = sum(a["walked"] for _, a in found or ())
    if not walked:
        return None
    return 100.0 * sum(a["servers_changed"] for _, a in found) / walked
