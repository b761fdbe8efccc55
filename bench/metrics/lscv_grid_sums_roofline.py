"""`lscv_grid_sums`'s share of its roofline over the traced window: the
bound of its launches (`bench/roofline.py`; one column's S at the
configuration's capacity, the configuration's grid) over their device
time."""
from bench import roofline


def read(run):
    if run.device is None:
        return None
    cfg = run.cell.config
    return roofline.share_pct(roofline.lscv_grid_sums_s(int(cfg["capacity"]), int(cfg["n_h"])),
                              run.device.family_launches.get("lscv_grid_sums", 0),
                              run.device.family_s.get("lscv_grid_sums", 0.0))
