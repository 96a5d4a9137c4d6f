"""Two threads on one device: the port's shared state under a server's
batch worker and job runner (CPU; no nvcc, no card).

* the library builds (``ops/kernels/build.py``, ``io/native.py``) run once
  under one lock, each compiler into a temporary file of its own thread;
* the SOCS kernel-set cache (``simulate._SOCS_BUILD_CACHE``) is looked up,
  filled and evicted under its lock;
* the launch counter (``intensity_int8.count_launch``) loses no launch;
* the port's counter store (``_spans.Counters``) keeps exact totals and
  window tallies under 8 threads, and each thread's spans nest under its
  own parents.

In each race the shared step yields the interpreter to the other thread
(``time.sleep(0)``) at the point where an unguarded read-modify-write or
iteration would be interleaved.
"""

import importlib
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lithographysimulator_tpu_torch import OpticsConfig
from lithographysimulator_tpu_torch.utils import profiling
from lithographysimulator_tpu_torch.io import native
from lithographysimulator_tpu_torch.ops.kernels import build
from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

psim = importlib.import_module("lithographysimulator_tpu_torch.simulate")


def _together(fn, threads: int = 2, timeout: float = 120.0) -> list:
    """Run ``fn()`` in ``threads`` threads released at once; their results
    (re-raising the first error)."""
    barrier = threading.Barrier(threads)
    results, errors = [None] * threads, []

    def run(i):
        try:
            barrier.wait(timeout)
            results[i] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    workers = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout)
    assert not any(w.is_alive() for w in workers)
    if errors:
        raise errors[0]
    return results


def test_kernel_build_runs_once_for_two_threads(tmp_path, monkeypatch):
    calls = []

    def slow_nvcc(cmd, **kwargs):
        calls.append((threading.get_ident(), cmd))
        time.sleep(0.2)  # the other thread arrives while this one compiles
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return type("Done", (), {"returncode": 0, "stdout": "ptxas ok\n",
                                 "stderr": ""})()

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", slow_nvcc)
    first, second = _together(build.build)
    assert first == second and first[0].read_bytes() == b"lib"
    assert len(calls) == 1
    ident, cmd = calls[0]
    tmp = cmd[cmd.index("-o") + 1]
    assert tmp.endswith(f".{ident}.tmp")  # this process's and thread's file
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".log", ".so"]


def test_rasterizer_builds_once_for_two_threads(tmp_path, monkeypatch):
    real_run = build.subprocess.run
    calls = []

    def counted(cmd, **kwargs):
        calls.append(cmd)
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.subprocess, "run", counted)
    monkeypatch.setattr(native, "_LIBRARY", None)
    square = [(0.0, 0.0), (40.0, 0.0), (40.0, 40.0), (0.0, 40.0)]
    grids = _together(lambda: native.rasterize([square], pixel_size=10.0, n=8))
    assert len(calls) == 1 and calls[0][0] == "g++"
    for g in grids:
        assert g.sum() == 16
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]


class _YieldingBytes:
    """A kernel stack whose ``nbytes`` hands the interpreter to the other
    thread mid-read, as a long computation there would."""

    @property
    def nbytes(self) -> int:
        time.sleep(0)
        return 1024


class _FakeKernels:
    def __init__(self):
        self.kernels = _YieldingBytes()
        self.eigenvalues = torch.ones(2)
        self.rank = 2


def test_socs_cache_survives_concurrent_insertion_and_eviction(monkeypatch):
    """Two threads fill the cache with distinct keys past its bound; every
    eviction sums the entries' bytes, and the sum yields to the other
    thread, which inserts meanwhile."""
    cfg = OpticsConfig(pixel_number=8)
    src = np.ones((8, 8), np.float32)
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE", {})
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE_MAX", 3)
    monkeypatch.setattr(psim, "_socs_build", lambda *a, **k: _FakeKernels())
    # a fake kernel stack has no kernels to take the bound's terms from
    monkeypatch.setattr(psim, "socs_bound_terms", lambda *a, **k: None)

    def fill(tag):
        for i in range(200):
            ab = np.array([0.0, 0.0, 1e-3 * i, float(tag)], np.float32)
            assert psim._socs_kernels_cached(cfg, src, ab, 2,
                                             device="cpu")[0].rank == 2
        return True

    tags = iter(range(2))
    lock = threading.Lock()

    def run():
        with lock:
            tag = next(tags)
        return fill(tag)

    assert _together(run) == [True, True]
    assert psim.socs_cache_stats() == (3, 3 * 1024)


class _YieldingCount(int):
    """A count whose addition hands the interpreter to another thread
    between the read and the write of ``LAUNCHES[name] += 1``."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingCount(int(self) + other)


def test_launch_counter_loses_no_launch(monkeypatch):
    monkeypatch.setitem(ik.LAUNCHES, "row_limb_gemm", _YieldingCount(0))
    per_thread = 500

    def launch():
        for _ in range(per_thread):
            ik.count_launch("row_limb_gemm")
        return True

    assert all(_together(launch, threads=4))
    assert ik.LAUNCHES["row_limb_gemm"] == 4 * per_thread


def test_counters_stay_exact_under_eight_threads():
    """8 threads add to one group and launch through ``count_launch``
    while a trace records, with a short switch interval: the totals, the
    window tallies and ``LAUNCHES`` lose nothing, and
    ``reset_launch_counts`` zeroes the same dict the store counts in."""
    from torch.profiler import ProfilerActivity, profile

    counts = profiling.Counters("race", ("calls",))
    per_thread = 2000
    ik.reset_launch_counts()
    launches = ik.LAUNCHES

    def add():
        for _ in range(per_thread):
            counts.add("calls")
            ik.count_launch("column_intensity")
        return True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            assert all(_together(add, threads=8))
    finally:
        sys.setswitchinterval(interval)
    tally = profiling.recording()["counters"]
    assert counts.totals["calls"] == tally["race.calls"] == 8 * per_thread
    assert tally["int8_launches.column_intensity"] == 8 * per_thread
    assert ik.LAUNCHES is launches and launches["column_intensity"] == 8 * per_thread
    ik.reset_launch_counts()
    assert set(ik.LAUNCHES.values()) == {0}


def test_each_threads_spans_nest_under_its_own_parents():
    from torch.profiler import ProfilerActivity, profile

    def nest():
        for _ in range(200):
            with profiling.span("litho.outer"):
                with profiling.span("litho.inner"):
                    time.sleep(0)
        return threading.get_ident()

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        idents = _together(nest, threads=8)
    spans = profiling.recording()["spans"]
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans) == 8 * 400
    assert {s["thread"] for s in spans} == set(idents)
    for s in spans:
        if s["name"] == "litho.inner":
            parent = by_id[s["parent"]]
            assert parent["name"] == "litho.outer"
            assert parent["thread"] == s["thread"]
        else:
            assert s["parent"] is None
