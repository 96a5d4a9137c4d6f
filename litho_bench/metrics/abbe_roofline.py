"""The exact images' contraction least time (rooflines/abbe_apply.py,
counted from the configuration's source and the grid: every field of every
image completed in the window) over the window's device busy time."""

import importlib.util
from pathlib import Path


def _count():
    path = Path(__file__).resolve().parent.parent / "rooflines" / "abbe_apply.py"
    spec = importlib.util.spec_from_file_location("litho_bench_roofline_abbe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(run):
    t, w = run["trace"], run["window"]
    if t is None or not w.get("abbe_fields") or t["busy_s"] <= 0:
        return None
    least, _ = _count().least_s(w["abbe_fields"], w["abbe_passes"], w["abbe_n"])
    return 100.0 * least / t["busy_s"]
