"""Device description and stage timing.

Port of ``lithographysimulator_tpu/utils/profiling.py``. On a CUDA device a
stage is timed with CUDA events recorded on the current stream, so the time
is the device's own and the host does not wait inside the stage; on the CPU
with ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import time

import torch


class StageTimer:
    """Collects named stage times in seconds on one device.

    >>> timer = StageTimer("cuda")
    >>> with timer.stage("spectrum"):
    ...     spec = mask_spectrum(geom, cfg)
    >>> timer.report()
    {'spectrum': 0.0012}
    """

    def __init__(self, device):
        self.device = torch.device(device)
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

    def report(self) -> dict:
        """Stage times so far; waits for the device's recorded stages."""
        for name, start, end in self._events:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1000.0)
        self._events.clear()
        return dict(self.times)


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
