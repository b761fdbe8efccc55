"""Mean host time of `QueryEngine.execute` per refresh, lazy fits and
answers included (the benchmark's own clock around the call)."""


def read(run):
    return sum(r.t2 - r.t1 for r in run.refreshes) / len(run.refreshes) * 1e3
