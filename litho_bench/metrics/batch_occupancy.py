"""Requests a batch over the window: the change of the worker's /health
counters requests_served over batches_run."""


def read(run):
    w = run["window"]
    if not w.get("batches"):
        return None
    return w["served"] / w["batches"]
