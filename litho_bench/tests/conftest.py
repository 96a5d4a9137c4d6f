"""Fixtures of the benchmark's CPU tests: a scratch copy of the benchmark
with small configurations and traffic, run on the CPU through the port's
plain kernel versions. Whether a card is there is decided inside the
``card`` fixture, never at import."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CLIP = {"pixel_number": 64, "socs_rank": 16,
             "layout": {"block_px": 32, "min_px": 4, "max_width_px": 8,
                        "max_space_px": 8, "max_contact_px": 6},
             "reference": {"oversample": 32, "iterations": 4},
             "limits": {"image_nrms": 1.5e-5, "broadband_nrms": 2e-6}}
# a tile's core (32 px) spans four blocks, as a 1024^2 tile's spans dozens
TINY_CHIP = dict(TINY_CLIP, chip_px=256, halo_px=16,
                 layout={"block_px": 16, "min_px": 3, "max_width_px": 5,
                         "max_space_px": 5, "max_contact_px": 4})
TINY_TRAFFIC = {"socs_stream": {"pool": 4, "sample": 2},
                "tiled_image": {"pool": 2, "sample_calls": 1, "sample_tiles": 3},
                "serve_closed8": {"pool": 4, "sample": 2, "clients": 2}}


def load(path: Path) -> dict:
    return json.loads(path.read_text())


def write(path: Path, obj: dict) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture
def tiny_bench(tmp_path):
    """(root, bench dir, BENCHMARK.json object) of a scratch checkout
    whose cells run at CPU sizes: the same files, with each configuration
    and traffic mix cut down in place."""
    shutil.copytree(ROOT / "litho_bench", tmp_path / "litho_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = load(ROOT / "BENCHMARK.json")
    bench_dir = tmp_path / "litho_bench"
    for cfg in bench["configs"]:
        path = tmp_path / cfg["file"]
        small = TINY_CHIP if "chip_px" in load(path) else TINY_CLIP
        write(path, {**load(path), **small})
    for name, small in TINY_TRAFFIC.items():
        path = bench_dir / "traffic" / f"{name}.json"
        if path.exists():
            write(path, {**load(path), **small})
    write(tmp_path / "BENCHMARK.json", bench)
    return tmp_path, bench_dir, bench


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's int8 kernels at the "
                    "cell's own size)")
    return "cuda"
