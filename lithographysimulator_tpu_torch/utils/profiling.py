"""Device description, stage timing, profiler traces, and the port's spans
and counters.

Port of ``lithographysimulator_tpu/utils/profiling.py``. On a CUDA device a
stage is timed with CUDA events recorded on the current stream, so the time
is the device's own and the host does not wait inside the stage; on the CPU
with ``time.perf_counter``. :func:`trace` and :func:`annotate` are the JAX
package's ``jax.profiler`` helpers on ``torch.profiler``. The spans and
counters (:func:`span`, :class:`Counters`, :func:`recording`, ...) are
:mod:`.._spans`'s, re-exported here: an operator gets them by tracing with
:func:`trace` or with a ``torch.profiler`` of their own.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import time
from pathlib import Path

import torch

from .._spans import (Counters, current_request, end_span,  # noqa: F401
                      recording, request_scope, reset, span, stamp)

logger = logging.getLogger("lithographysimulator_tpu_torch")


class StageTimer:
    """Collects named stage times in seconds on one device.

    >>> timer = StageTimer("cuda")
    >>> with timer.stage("spectrum"):
    ...     spec = mask_spectrum(geom, cfg)
    >>> timer.report()
    {'spectrum': 0.0012}
    """

    def __init__(self, device, *, log: bool = False):
        self.device = torch.device(device)
        self.log = log
        self.times: dict[str, float] = {}
        self._events: list = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + seconds
        if self.log:
            logger.info("stage %s: %.4f s", name, seconds)

    def report(self) -> dict:
        """Stage times so far; waits for the device's recorded stages."""
        for name, start, end in self._events:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1000.0)
        self._events.clear()
        return dict(self.times)


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace (host, and the card's kernels
    where there is one) around a block and write it to ``log_dir`` as a
    Chrome trace (``trace.json``; view it in Perfetto or chrome://tracing),
    with the port's spans and counter tallies of the block beside it
    (``spans.json``, :func:`recording`).

    >>> with trace("litho-trace"):
    ...     image = simulate(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "spans.json").write_text(json.dumps(recording()))


def annotate(name: str):
    """Decorator: label a function's work as the span ``name`` in profiler
    traces and in the recording (:func:`span`). ``bench.`` names belong to
    the benchmark's own spans and are refused."""
    if name.startswith("bench."):
        raise ValueError(f"span name {name!r}: 'bench.' names are the "
                         "benchmark's")

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def device_info(device) -> dict:
    """What the port runs on: platform, device count and name."""
    device = torch.device(device)
    if device.type == "cuda":
        return {
            "platform": "gpu",
            "device_count": torch.cuda.device_count(),
            "device": torch.cuda.get_device_name(device),
            "capability": list(torch.cuda.get_device_capability(device)),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
    return {"platform": "cpu", "device_count": 1, "device": "cpu",
            "torch": torch.__version__}
