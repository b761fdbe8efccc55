"""Share of the traced run's profiled part in which no operation ran on
the card (the profiler's device timeline)."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
