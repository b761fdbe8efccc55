"""Nelder-Mead evaluations of LSCV_H per refresh: the program's launch
counter of `gh_fused_sum` (`kernels/ops.launch_counts`) over the window."""


def read(run):
    n = run.launches.get("gh_fused_sum", 0)
    return n / len(run.refreshes) if n else None
