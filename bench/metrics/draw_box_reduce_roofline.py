"""`draw_box_reduce`'s share of its roofline over the traced window: the
bound of a refresh's launches over their device time a refresh.

The bound is the larger of the bytes over the HBM bandwidth and the
operations over the FP32 peak (`bench/roofline.py`'s peaks), at the cell's
shape: m rows of the joint reservoir (the configuration's capacity), K =
`box_draws` draws a row, q boxes (the dashboard's), d columns, the CI's
k = min(`qmc_subsamples`, m // 2) row chunks.  Operations: per draw
d(d+1) for x_i + L z (a multiply-add counts as two); per draw and box
2d + 3 (the bound tests, the count, the SUM's multiply-add).  Bytes: x, L,
the boxes and targets and the (2, k + 1, q) float64 sums, each once; the
standard-normal draws z are a constant of (m, K, d), depend on no input
and are not counted.  Launches a refresh come from the program's launch
counter over the untraced part, device time from the kernel's two device
functions (`draw_box_tiles`, `draw_box_finish`) in the profiled part."""
from bench import roofline


def draw_box_reduce_s(m: int, draws: int, q: int, d: int, chunks: int) -> float:
    n_draws = m * draws
    flops = n_draws * d * (d + 1) + n_draws * q * (2 * d + 3)
    nbytes = 4 * m * d + 4 * d * d + 8 * q * d + 4 * q + 16 * (chunks + 1) * q
    return max(nbytes / roofline.PEAK_BYTES, flops / roofline.PEAK_FP32)


def _shape(cfg: dict, traffic: dict):
    m = int(cfg["capacity"])
    q = sum(int(e["count"]) for e in traffic["dashboard"] if e["kind"] == "box")
    return m, int(cfg["box_draws"]), q, len(cfg["joints"][0]), min(int(cfg["qmc_subsamples"]),
                                                                    m // 2)


def read(run):
    launches = run.launches.get("draw_box_reduce", 0)
    if run.device is None or not launches or not run.refreshes or not run.device_refreshes:
        return None
    device_s = sum(v for k, v in run.device.family_s.items() if "draw_box" in k)
    per_refresh = launches / len(run.refreshes) * run.device_refreshes
    return roofline.share_pct(draw_box_reduce_s(*_shape(run.cell.config, run.cell.traffic)),
                              per_refresh, device_s)
