"""The images' contraction least time (rooflines/socs_apply.py, counted
from rank and sizes: every SOCS image completed in the window) over the
window's device busy time."""

import importlib.util
from pathlib import Path


def _count():
    path = Path(__file__).resolve().parent.parent / "rooflines" / "socs_apply.py"
    spec = importlib.util.spec_from_file_location("litho_bench_roofline_socs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(run):
    t, w = run["trace"], run["window"]
    if t is None or not w.get("socs_images") or t["busy_s"] <= 0:
        return None
    least, _ = _count().image_least_s(w["socs_rank"], w["socs_n"])
    return 100.0 * least * w["socs_images"] / t["busy_s"]
