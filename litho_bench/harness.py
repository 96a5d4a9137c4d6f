"""The benchmark's core: find a cell's files by name, run it, read its metrics.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, which this module finds by the name that
``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the optics and sizes as they are run, the
  limits of the comparison, ``source``, ``assumed`` and ``reduced``;
* ``traffic/<mix>.json``: the parameters of a traffic mix, among them the
  ``driver`` (``drivers/<driver>.py``) that generates it from them;
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of one
  metric, end to end or per layer. A reader that finds nothing returns
  None, and the metric is left out of the result line. Where there is no
  file of the metric's whole name, the reader of its base name (the part
  before the first dot) serves: ``metrics/device_idle_pct.py`` reads
  ``device_idle_pct.mpx`` and ``device_idle_pct.chip`` alike.

A driver has ``setup(ctx) -> state``, ``window(state, ctx, seconds) ->
record`` (the timed loop; it wraps each call into the program in
``ctx.span(name)``), optionally ``release(state)`` (frees the program's
state once the window has closed and the memory peak has been read), and
``compare(state, record, ctx) -> [(name, value, limit), ...]``: the
reference's verdict on what the window produced, each number beside its
limit. A run is correct when every number is finite and at most its limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lithographysimulator_tpu")


@dataclasses.dataclass
class Context:
    """What a driver is handed: the cell and its files' contents, the seed
    and the device, and ``span`` (a context manager factory that marks a
    range of the host's work in a traced run)."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: str
    span: object = contextlib.nullcontext


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, root: Path, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return load_json(root / cfg["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def _module_from(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_of(kind: str, bench_dir: Path = BENCH_DIR):
    return _module_from(bench_dir / "drivers" / f"{kind}.py",
                        f"litho_bench_driver_{kind}")


def reader_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    return path


def reader_of(metric: str, bench_dir: Path = BENCH_DIR):
    return _module_from(reader_path(metric, bench_dir),
                        "litho_bench_metric_" + metric.replace(".", "_"))


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its relatives' or the
    JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run(bench: dict, root: Path, cell_name: str, seed: int, seconds: float,
        trace: bool, *, device: str, t_start: float,
        bench_dir: Path = BENCH_DIR) -> dict:
    """One run of a cell: set-up, the window (traced or not), the
    comparison, the metrics. Returns the result line's object, with the
    compared numbers under ``checks``."""
    from . import tracing

    cell = cell_of(bench, cell_name)
    ctx = Context(cell=cell, config=config_of(bench, root, cell["config"]),
                  traffic=traffic_of(cell["traffic"], bench_dir),
                  seed=int(seed), device=device)
    drv = driver_of(ctx.traffic["driver"], bench_dir)
    dev = tracing.Device(device)
    state = drv.setup(ctx)
    profiler = tracing.Profiler(dev) if trace else None
    if profiler is not None:
        ctx.span = tracing.span
        profiler.start()
    dev.sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with ctx.span("bench.window"):
        record = drv.window(state, ctx, seconds)
    dev.sync()
    window_s = time.perf_counter() - t0
    record.setdefault("seconds", window_s)
    trace_summary = profiler.stop() if profiler is not None else None
    memory_peak = dev.memory_peak()
    if hasattr(drv, "release"):
        drv.release(state)
    checks = drv.compare(state, record, ctx)
    correct = bool(checks) and all(_finite(v) and v <= lim
                                   for _, v, lim in checks)
    run_record = {"cell": cell, "config": ctx.config, "traffic": ctx.traffic,
                  "window": record, "trace": trace_summary, "setup_s": setup_s}
    metrics = {}
    for m in metrics_for(bench, cell_name, trace):
        value = reader_of(m["name"], bench_dir).read(run_record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_out = dev.info()
    device_out["memory_peak_bytes"] = int(memory_peak)
    out = {"correct": correct, "attempted": int(record["attempted"]),
           "failed": int(record.get("failed", 0)), "metrics": metrics,
           "device": device_out}
    if trace_summary is not None:
        device_out["busy_s"] = trace_summary["busy_s"]
        device_out["window_s"] = trace_summary["window_s"]
        out["breakdown"] = {"device_ops": trace_summary["device_ops"],
                            "idle_gaps": trace_summary["idle_gaps"]}
    out["checks"] = {name: {"value": float(v), "limit": float(lim)}
                     for name, v, lim in checks}
    return out
