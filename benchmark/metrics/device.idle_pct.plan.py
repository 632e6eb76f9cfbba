"""The share of the traced window in which no operation ran on the card."""


def read(run):
    tr = run.get("trace")
    if tr is None or run.get("kind") != "planner" or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
