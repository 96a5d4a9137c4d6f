"""The server's own wire work a request: the median over requests of the
summed durations of the port's ``litho.serve.read``, ``.decode`` and
``.encode`` spans that carry its request id (the body off the socket, JSON
and base64 both ways, the reply's write): the server's share of what
``serve_overhead_ms`` sees from outside. A port without the span recording
reads nothing."""

import statistics
from collections import defaultdict

WIRE = ("litho.serve.read", "litho.serve.decode", "litho.serve.encode")


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
    wire, seen = defaultdict(int), defaultdict(set)
    for s in spans:
        if s["name"] in WIRE and s["request"] is not None:
            wire[s["request"]] += s["end_ns"] - s["start_ns"]
            seen[s["request"]].add(s["name"])
    whole = [ns for rid, ns in wire.items() if len(seen[rid]) == len(WIRE)]
    return statistics.median(whole) / 1e6 if whole else None
