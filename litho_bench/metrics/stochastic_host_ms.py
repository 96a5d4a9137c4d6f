"""Host work of a stochastic ensemble: the median over the window's calls
of the summed ``litho.stochastic.edges`` and ``litho.stochastic.psd`` spans
under each ``litho.stochastic`` span (the edge tables, the run-count
compare, the edge PSD and its fit). Read from the port's span recording,
which a traced run fills; a port without the spans reads nothing."""

import statistics


def _spans():
    try:
        from lithographysimulator_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    return recording()["spans"]


def _per_call(run, names) -> float | None:
    """Median over the ``litho.stochastic`` spans of the summed duration
    (ms) of their children named ``names``."""
    spans = None if run["trace"] is None else _spans()
    if not spans:
        return None
    calls = {s["id"]: 0 for s in spans if s["name"] == "litho.stochastic"}
    for s in spans:
        if s["name"] in names and s["parent"] in calls:
            calls[s["parent"]] += s["end_ns"] - s["start_ns"]
    return statistics.median(calls.values()) / 1e6 if calls else None


def read(run):
    return _per_call(run, ("litho.stochastic.edges", "litho.stochastic.psd"))
