"""Mean of the sharded planner's own plan time (``last_solve_ms``) over the
window's rounds: the device plan's launches and its readback."""


def read(run):
    r = run.get("rounds") if run.get("kind") == "planner" else None
    if not r:
        return None
    return sum(x[3] for x in r) / len(r)
