"""The device, and the reading of a traced window from ``torch.profiler``.

The trace reading follows the port's ``tools/profile_port.py`` (device
events from ``torch.profiler``, the host gap as the window less the
device's time), with one change: the device's busy
time is the union of the intervals in which any device operation ran, so
that operations that overlap (two streams, a copy beside a kernel) are not
counted twice. The idle gaps inside the window are named by what the host
was doing while the device waited: the innermost benchmark span
(``bench.*``, marked around each call into the program) and the host
operation that started last among those still running.
"""

from __future__ import annotations

import bisect
import heapq
import subprocess
from collections import defaultdict

import torch

TOP = 10


class Device:
    """Synchronization, the memory peak and the description of the run's
    device: a CUDA card, or the CPU (the tests' small runs)."""

    def __init__(self, device: str):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def info(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device),
               "count": 1}
        try:
            limit = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                 "-i", str(self.device.index or 0)],
                capture_output=True, text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            limit = ""
        if limit:
            out["power_limit"] = limit
        return out


def span(name: str):
    return torch.profiler.record_function(name)


def merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(points: list[int], events: list[tuple[int, int, str]]) -> dict:
    """{point: name of the latest-started event still running there, or
    "after <name>" of the event that ended last before it}."""
    events = sorted(events)
    by_end = sorted((e, name) for _, e, name in events)
    ends = [e for e, _ in by_end]
    heap: list[tuple[int, int, str]] = []
    out, k = {}, 0
    for p in sorted(points):
        while k < len(events) and events[k][0] <= p:
            s, e, name = events[k]
            heapq.heappush(heap, (-s, e, name))
            k += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        if heap:
            out[p] = heap[0][2]
        else:
            i = bisect.bisect_right(ends, p) - 1
            out[p] = f"after {by_end[i][1]}" if i >= 0 else "none"
    return out


def summarize(device_events, host_events, spans, window: tuple[int, int]) -> dict:
    """Busy time, the operations that took most time, and the idle gaps of one
    window ``(start_ns, end_ns)``. ``device_events`` and ``host_events``
    are ``(start_ns, end_ns, name)``; ``spans`` the benchmark's own."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for s, e, _ in device_events
               if e > w0 and s < w1]
    busy = merged(clipped)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict[str, float] = defaultdict(float)
    for s, e, name in device_events:
        if e > w0 and s < w1:
            by_name[name] += (min(e, w1) - max(s, w0)) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mids = [(s + e) // 2 for s, e in gaps]
    in_span = _innermost(mids, spans)
    in_host = _innermost(mids, host_events)
    idle: dict[str, float] = defaultdict(float)
    for (s, e), mid in zip(gaps, mids):
        idle[f"{in_span[mid]} | {in_host[mid]}"] += (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": [[name[:120], sec] for name, sec in top],
            "idle_gaps": [[k[:200], v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}


class Profiler:
    """``torch.profiler`` over the window (the card's kernels, copies and
    memsets, and the host's operations and the benchmark's spans)."""

    def __init__(self, device: Device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> dict:
        self.prof.stop()
        device_events, host_events, spans = [], [], []
        window = None
        for ev in self.prof.profiler.kineto_results.events():
            s, e = ev.start_ns(), ev.end_ns()
            name = ev.name()
            if ev.device_type() != torch.autograd.DeviceType.CPU:
                # a benchmark span's shadow on the device's timeline is no
                # operation of the device
                if not name.startswith("bench."):
                    device_events.append((s, e, name))
            elif name == "bench.window":
                window = (s, e)
            elif name.startswith("bench."):
                spans.append((s, e, name))
            else:
                host_events.append((s, e, name))
        if window is None:
            raise RuntimeError("the trace holds no bench.window span")
        return summarize(device_events, host_events, spans, window)
