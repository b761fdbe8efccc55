"""Nelder-Mead round trips of LSCV_H per refresh: the program's `nm.eval`
spans (`core/nelder_mead.py`: one a batch of points evaluated and read back
to the host) over the spans part's refreshes.  Beside `nm_evals` it tells
how many evaluations share a round trip."""


def read(run):
    spans = [s for s in run.spans if s["name"] == "nm.eval"]
    if not spans or not run.span_refreshes:
        return None
    return len(spans) / run.span_refreshes
