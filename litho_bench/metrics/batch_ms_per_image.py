"""The batch worker's time an image: the summed durations of the port's
``litho.serve.batch.run`` spans (``simulate_batch`` and the read-back) over
the images those batches made (the ``size`` of each run's
``litho.serve.batch`` parent). Against the int8 apply's time an image it
shows how far the worker is held back. A port without the span recording
reads nothing."""


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
    sizes = {s["id"]: s["attrs"].get("size", 0) for s in spans
             if s["name"] == "litho.serve.batch"}
    runs = [(s["end_ns"] - s["start_ns"], sizes[s["parent"]]) for s in spans
            if s["name"] == "litho.serve.batch.run" and s["parent"] in sizes]
    images = sum(n for _, n in runs)
    return sum(ns for ns, _ in runs) / images / 1e6 if images else None
