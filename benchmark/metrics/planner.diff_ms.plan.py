"""Mean milliseconds a round in the sharded planner's span
``planner:ingest.diff``: the walk over every server's stamps that finds the
servers whose snapshot changed."""

from benchmark.common import span_ms


def read(run):
    return span_ms(run, "planner:ingest.diff")
