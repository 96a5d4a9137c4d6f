"""The host's time to enqueue a tile: the median duration of the port's
``litho.tiled.tile`` spans (a tile's window, spectrum, apply and stitch as
the host issues them). Near the device's time a tile, the host paces the
device; far below it, the device's idle gaps lie elsewhere. A port without
the span recording reads nothing."""

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
    tiles = [s["end_ns"] - s["start_ns"] for s in spans
             if s["name"] == "litho.tiled.tile"]
    return statistics.median(tiles) / 1e6 if tiles else None
