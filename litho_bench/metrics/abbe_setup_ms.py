"""Per-call set-up of the exact engine's windowed path: the median over the
window's passes of the port's ``litho.abbe.setup`` span (T0's planes, their
int8 limbs and the window starts, before the first chunk). Read from the
port's span recording, which a traced run fills; a port without the span
reads nothing."""

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
    times = [s["end_ns"] - s["start_ns"] for s in spans
             if s["name"] == "litho.abbe.setup"]
    return statistics.median(times) / 1e6 if times else None
