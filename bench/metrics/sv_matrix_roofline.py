"""`sv_matrix`'s share of its roofline over the traced window: the bound of
its launches (`bench/roofline.py`; S of one column's reservoir, full at the
configuration's capacity, d = 1) over their device time."""
from bench import roofline


def read(run):
    if run.device is None:
        return None
    n = int(run.cell.config["capacity"])
    return roofline.share_pct(roofline.sv_matrix_s(n, 1),
                              run.device.family_launches.get("sv_matrix", 0),
                              run.device.family_s.get("sv_matrix", 0.0))
