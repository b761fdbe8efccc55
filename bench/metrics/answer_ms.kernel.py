"""The program's `engine.kernel` spans of the kernel-centred full-H path
per refresh (`core/aqp_query.py` `_run_group`, path "qmc:kernel:cuda": the
Cholesky factor of H, one copy of it and the boxes to the card, the
draw_box_reduce launch with its CI chunks, one copy back), fenced latency
with the device work inside.  Read in the traced run's part with the
spans on, as `plan_ms` is."""


def read(run):
    spans = [s for s in run.spans if s["name"] == "engine.kernel"
             and s["attrs"].get("path") == "qmc:kernel:cuda"]
    if not spans or not run.span_refreshes:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / run.span_refreshes * 1e3
