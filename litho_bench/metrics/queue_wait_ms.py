"""A served request's wait in the worker's queue: the median duration of
the port's ``litho.serve.queue`` spans (from the enqueue to the batch
worker's take, the coalescing window included). A port without the span
recording reads nothing."""

import statistics


def _spans():
    try:
        from lithographysimulator_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    return recording()["spans"]


def read(run):
    spans = None if run["trace"] is None else _spans()
    if not spans:
        return None
    waits = [s["end_ns"] - s["start_ns"] for s in spans
             if s["name"] == "litho.serve.queue"]
    return statistics.median(waits) / 1e6 if waits else None
