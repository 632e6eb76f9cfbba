"""Mean milliseconds a round in the sharded planner's span
``planner:ingest.reqrows``: the changed servers' requester rows staged for
the auction kernel's prologue (device tier)."""

from benchmark.common import span_ms


def read(run):
    return span_ms(run, "planner:ingest.reqrows")
