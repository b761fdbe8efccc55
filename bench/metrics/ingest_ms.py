"""Mean host time of `TelemetryStore.add_batch` per refresh (the
benchmark's own clock around the call)."""


def read(run):
    return sum(r.t1 - r.t0 for r in run.refreshes) / len(run.refreshes) * 1e3
