"""Device time per refresh of the LSCV_h fit's kernels (`sv_matrix`, then
`lscv_grid_sums` over its S), from the traced run's profiled part."""


def read(run):
    if run.device is None:
        return None
    fams = run.device.family_s
    if "sv_matrix" not in fams and "lscv_grid_sums" not in fams:
        return None
    return (fams.get("sv_matrix", 0.0) + fams.get("lscv_grid_sums", 0.0)) \
        / run.device_refreshes * 1e3
