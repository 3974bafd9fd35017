"""solve_s_p90: 90th percentile of the times of all requests in the
window, each from the observation array on the host to the answer on the
host."""

import numpy as np


def read(run):
    lat = [r["end"] - r["start"] for r in run.requests]
    return float(np.percentile(lat, 90)) if lat else None
