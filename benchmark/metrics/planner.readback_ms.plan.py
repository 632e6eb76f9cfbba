"""Mean milliseconds a round in the sharded planner's span
``planner:plan.readback``: the host blocked until the device plan's output
has landed."""

from benchmark.common import span_ms


def read(run):
    return span_ms(run, "planner:plan.readback")
