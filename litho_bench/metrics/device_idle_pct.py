"""Share of the traced window in which no device operation ran: 1 minus
the union of the device's operation intervals over the window."""


def read(run):
    t = run["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
