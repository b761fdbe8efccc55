"""The program's `engine.plan` spans per refresh (`core/aqp_query.py`
`_execute`): resolving every spec to its group, which fits the moved
synopses lazily.  Read in the traced run's part with the spans on, apart
from its profiled part."""


def read(run):
    spans = [s for s in run.spans if s["name"] == "engine.plan"]
    if not spans or not run.span_refreshes:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / run.span_refreshes * 1e3
