"""The program's `synopsis.fit` spans of its LSCV_H fits per refresh
(`core/aqp.py` `KDESynopsis.fit`, selector "lscv_H": the Nelder-Mead loop,
a gh_fused_sum launch an evaluation and one copy to the host a round trip,
`nm_round_trips`), fenced latency with the device work inside.  Read in
the traced run's part with the spans on, as `plan_ms` is; over `nm_evals`
it is one evaluation's latency."""


def read(run):
    spans = [s for s in run.spans
             if s["name"] == "synopsis.fit" and s["attrs"].get("selector") == "lscv_H"]
    if not spans or not run.span_refreshes:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / run.span_refreshes * 1e3
