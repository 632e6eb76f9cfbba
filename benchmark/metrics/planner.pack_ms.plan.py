"""Mean milliseconds a round in the sharded planner's span
``planner:ingest.pack``: the changed servers' task and requester lists
packed into the host's mirror."""

from benchmark.common import span_ms


def read(run):
    return span_ms(run, "planner:ingest.pack")
