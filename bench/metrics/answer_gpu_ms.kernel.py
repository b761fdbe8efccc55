"""Device time per refresh of the kernel-centred box answers: the
`draw_box_reduce` kernel's two device functions (`draw_box_tiles`, one
block a tile of sample rows' draws, and `draw_box_finish`, the chunks'
sums in order), one launch a full-H group, from the traced run's profiled
part."""


def read(run):
    if run.device is None or not run.device_refreshes:
        return None
    device_s = sum(v for k, v in run.device.family_s.items() if "draw_box" in k)
    return device_s / run.device_refreshes * 1e3 if device_s else None
