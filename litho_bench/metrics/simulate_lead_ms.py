"""Host lead of a simulate call: the median over the window's calls of the
time from the start of the port's ``litho.simulate`` span to the start of
its ``litho.simulate.spectrum`` child (inputs, the kernel set's cache key
and look-up), before the device gets any of the call's work. Read from the
port's span recording, which a traced run fills; a port without one reads
nothing."""

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
    roots = {s["id"]: s["start_ns"] for s in spans if s["name"] == "litho.simulate"}
    leads = [s["start_ns"] - roots[s["parent"]] for s in spans
             if s["name"] == "litho.simulate.spectrum" and s["parent"] in roots]
    return statistics.median(leads) / 1e6 if leads else None
