#!/usr/bin/env python3
"""Benchmark of lithographysimulator_tpu_torch on CUDA cards: one run of one cell.

    python3 litho_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up the cell that ``BENCHMARK.json``
names (inputs and weights from ``--seed``, every shape warmed up), measures
for ``--seconds``, has the plain reference judge what the window produced,
prints each compared number beside its limit as the last lines on standard
error, and prints one JSON object as the last line on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last. It exits with another code
than 0 and prints no result where there is no CUDA card (or fewer than the
cell asks for), where the run fails, or where JAX or the JAX package got
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _say(msg: str) -> None:
    print(f"litho_bench: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from litho_bench import harness

    bench = harness.benchmark(ROOT)
    cell = harness.cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        _say("no CUDA card: torch.cuda.is_available() is false; this "
             "benchmark measures the CUDA port and runs only on a card")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        _say(f"{args.workload} needs {cell['chips']} CUDA card(s), "
             f"{torch.cuda.device_count()} visible")
        return 2
    out = harness.run(bench, ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        _say(f"the run loaded {', '.join(found)}: the benchmark and the port "
             "must not load JAX or the JAX package")
        return 3
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"{name}: {c['value']!r} (limit {c['limit']!r}) {verdict}",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
