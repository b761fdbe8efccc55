"""The program's `synopsis.fit` spans of its LSCV_h fits per refresh
(`core/aqp.py` `KDESynopsis.fit`, selector "lscv_h": sv_matrix, then
lscv_grid_sums and the argmin), fenced latency with the device work inside.
Read in the traced run's part with the spans on, as `plan_ms` is."""


def read(run):
    spans = [s for s in run.spans
             if s["name"] == "synopsis.fit" and s["attrs"].get("selector") == "lscv_h"]
    if not spans or not run.span_refreshes:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / run.span_refreshes * 1e3
