"""Device time per refresh of the LSCV_H fit's objective kernel
(`gh_fused_sum`, one launch a Nelder-Mead evaluation), from the traced
run's profiled part."""


def read(run):
    if run.device is None or "gh_fused_sum" not in run.device.family_s:
        return None
    return run.device.family_s["gh_fused_sum"] / run.device_refreshes * 1e3
