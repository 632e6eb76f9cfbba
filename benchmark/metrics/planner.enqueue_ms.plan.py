"""Mean milliseconds a round in the sharded planner's span
``planner:plan.enqueue``: the device plan's launches enqueued (candidates,
then the auction)."""

from benchmark.common import span_ms


def read(run):
    return span_ms(run, "planner:plan.enqueue")
