"""`gh_fused_sum`'s share of its roofline over the traced window: the
bound of its launches (`bench/roofline.py`; the joint reservoir at the
configuration's capacity and width) over their device time."""
from bench import roofline


def read(run):
    if run.device is None:
        return None
    cfg = run.cell.config
    d = len(cfg["joints"][0])
    return roofline.share_pct(roofline.gh_fused_sum_s(int(cfg["capacity"]), d),
                              run.device.family_launches.get("gh_fused_sum", 0),
                              run.device.family_s.get("gh_fused_sum", 0.0))
