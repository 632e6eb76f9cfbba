"""Mean milliseconds a round in the sharded planner's span
``planner:ingest.upload``: the changed task rows copied to the card (a
round with no changed row counts 0)."""

from benchmark.common import span_ms


def read(run):
    return span_ms(run, "planner:ingest.upload")
