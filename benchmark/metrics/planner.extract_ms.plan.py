"""Mean milliseconds a round in the sharded planner's span
``planner:plan.extract``: the committed slots unpacked into pairs."""

from benchmark.common import span_ms


def read(run):
    return span_ms(run, "planner:plan.extract")
