"""parallel/distributed.py: two processes on the CPU start one gloo process
group through initialize_distributed and report the JAX package's four
keys; a second call in a running group changes nothing. Each process pays
one torch import (about 1-2 s here)."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

WORKER = """
import json, sys
import torch.distributed as dist
from lithographysimulator_tpu_torch.parallel import initialize_distributed
rank = int(sys.argv[1])
first = initialize_distributed(sys.argv[2], 2, rank, device="cpu")
again = initialize_distributed(sys.argv[2], 2, rank, device="cpu")
dist.destroy_process_group()
print(json.dumps({"first": first, "again": again}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_report_the_four_keys():
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(rank), address],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, out in enumerate(outs):
        expect = {"process_index": rank, "process_count": 2,
                  "local_devices": 1, "global_devices": 2}
        assert out["first"] == expect
        assert out["again"] == expect
