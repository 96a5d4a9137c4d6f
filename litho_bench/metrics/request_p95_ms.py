"""The 95th percentile of every request's latency in the window, from the
client's send to its decoded reply; a failed request counts as missing (as
long as the whole window)."""

import numpy as np


def read(run):
    lat = run["window"].get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
