"""The window's time over the refreshes completed in it (a refresh:
`add_batch` of one ingest batch, then `execute` of the dashboard)."""


def read(run):
    return run.window_s / len(run.refreshes) * 1e3
