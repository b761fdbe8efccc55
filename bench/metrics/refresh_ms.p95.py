"""The 95th percentile (linear interpolation) of every refresh of the
window, each from the call of `add_batch` to the return of `execute`."""
import numpy as np


def read(run):
    return float(np.percentile([(r.t2 - r.t0) * 1e3 for r in run.refreshes], 95))
