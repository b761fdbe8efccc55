"""Set-up: from the start of the process to the window's start (imports,
CUDA, the kernels' build or load, the stream, the store's ingest of the
set-up rows and one warm refresh)."""


def read(run):
    return run.setup_s
