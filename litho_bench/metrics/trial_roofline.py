"""The window's least device time over its device busy time: every SOCS
image's contraction (rooflines/socs_apply.py, from rank and sizes) plus
every trial of its stochastic ensembles (rooflines/stochastic_trials.py,
from the grid, the trials and the cut lines' step)."""

import importlib.util
from pathlib import Path


def _count(name: str):
    path = Path(__file__).resolve().parent.parent / "rooflines" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"litho_bench_roofline_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(run):
    t, w = run["trace"], run["window"]
    if t is None or not w.get("trials") or t["busy_s"] <= 0:
        return None
    apply_s, _ = _count("socs_apply").image_least_s(w["socs_rank"], w["socs_n"])
    trials_s = _count("stochastic_trials").least_s(w["trials"], w["socs_n"],
                                                   w["row_step"])
    return 100.0 * (apply_s * w["socs_images"] + trials_s) / t["busy_s"]
