"""The mean planning round on the host's clock, ingest call to returned
pairs: the rounds' summed time over their number."""


def read(run):
    r = run.get("rounds") if run.get("kind") == "planner" else None
    if not r:
        return None
    return 1e3 * sum(x[1] for x in r) / len(r)
