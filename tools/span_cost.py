"""The cost of the port's spans and counters on this host.

    PYTHONPATH=. python3 tools/span_cost.py [--spans 100000]

Times ``with span(...)`` and ``Counters.add`` in a loop, with no profiler
running (a flag check and a call) and under ``torch.profiler`` (host, and
the card where there is one: the span enters the trace and the recording),
and prints one JSON line: microseconds a span or addition each way, the
empty loop's own cost, the host's CPU and, where there is one, the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import platform
import subprocess
import time

import torch

from lithographysimulator_tpu_torch.utils import profiling


def _per_call_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n * 1e6


def _empty(n):
    for _ in range(n):
        pass


def _spans(n):
    span = profiling.span
    for _ in range(n):
        with span("litho.cost"):
            pass


def _counts(n):
    counters = profiling.Counters("cost", ("calls",))
    for _ in range(n):
        counters.add("calls")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", type=int, default=100_000)
    n = ap.parse_args(argv).spans
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = {"host": platform.processor() or platform.machine(),
           "torch": torch.__version__, "spans": n}
    for _ in range(2):  # the second round is the one kept
        out["empty_loop_us"] = _per_call_us(_empty, n)
        out["span_off_us"] = _per_call_us(_spans, n)
        out["count_off_us"] = _per_call_us(_counts, n)
        profiling.reset()
        with profile(activities=acts):
            out["span_on_us"] = _per_call_us(_spans, n)
            out["count_on_us"] = _per_call_us(_counts, n)
        recorded = profiling.recording()
        out["recorded"] = len(recorded["spans"])
        out["tallied"] = recorded["counters"].get("cost.calls", 0)
    profiling.reset()
    if torch.cuda.is_available():
        out["device"] = torch.cuda.get_device_name(0)
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
