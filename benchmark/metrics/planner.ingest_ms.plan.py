"""Mean of the sharded planner's own ingest time (``last_ingest_ms``) over
the window's rounds: the snapshot-delta ingest, host side."""


def read(run):
    r = run.get("rounds") if run.get("kind") == "planner" else None
    if not r:
        return None
    return sum(x[2] for x in r) / len(r)
