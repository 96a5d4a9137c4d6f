"""Median of (a request's client latency less its reply's
report.wall_clock_s): the wire path outside the service's own clock (JSON
parse, base64 both ways, HTTP)."""

import numpy as np


def read(run):
    over = run["window"].get("overheads_s")
    if not over:
        return None
    return 1e3 * float(np.median(over))
