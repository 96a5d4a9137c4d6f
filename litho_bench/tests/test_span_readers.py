"""The readers of the port's spans and counters on synthetic run records:
each reads its number from a recording made up here, reads nothing when
the run was not traced or when the port has no recording, and reads the
port's own recording of a small traced call."""

from __future__ import annotations

import sys
import types

import pytest

from conftest import ROOT

MS = 1_000_000


def _reader(name):
    from litho_bench import harness

    return harness.reader_of(name, ROOT / "litho_bench")


def _span(name, start_ms, end_ms, sid, parent=None, request=None, **attrs):
    return {"name": name, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "thread": 1, "id": sid,
            "parent": parent, "request": request, "attrs": attrs}


SPANS = [
    # two simulate calls: leads 4 ms and 6 ms; a spectrum outside any call
    _span("litho.simulate", 0, 40, 1),
    _span("litho.simulate.inputs", 0.5, 3, 2, 1),
    _span("litho.simulate.spectrum", 4, 5, 3, 1),
    _span("litho.simulate", 50, 90, 4),
    _span("litho.simulate.spectrum", 56, 57, 5, 4),
    _span("litho.simulate.spectrum", 100, 101, 6),
    # three tiles: 2, 3 and 10 ms
    _span("litho.tiled.tile", 0, 2, 10), _span("litho.tiled.tile", 5, 8, 11),
    _span("litho.tiled.tile", 10, 20, 12),
    # request 7 whole (1 + 2 + 1 + 3 ms of wire, 30 ms queued); request 8
    # whole (5 ms of wire, 10 ms queued); request 9 without its encode
    _span("litho.serve.read", 0, 1, 20, request=7),
    _span("litho.serve.decode", 1, 3, 21, request=7),
    _span("litho.serve.decode", 3, 4, 22, request=7),
    _span("litho.serve.queue", 4, 34, 23, request=7),
    _span("litho.serve.encode", 60, 63, 24, request=7),
    _span("litho.serve.read", 0, 2, 25, request=8),
    _span("litho.serve.decode", 2, 3, 26, request=8),
    _span("litho.serve.queue", 3, 13, 27, request=8),
    _span("litho.serve.encode", 40, 42, 28, request=8),
    _span("litho.serve.read", 0, 50, 29, request=9),
    _span("litho.serve.queue", 50, 70, 30, request=9),
    # two batches: 3 images in 30 ms, 1 image in 10 ms
    _span("litho.serve.batch", 30, 62, 40, size=3, requests=[7, 8, 9]),
    _span("litho.serve.batch.run", 32, 62, 41, 40),
    _span("litho.serve.batch", 70, 81, 42, size=1, requests=[10]),
    _span("litho.serve.batch.run", 71, 81, 43, 42),
]
COUNTERS = {"int8_launches.window_product_limbs": 640,
            "int8_launches.row_limb_gemm": 640,
            "int8_launches.row_requantize": 640,
            "int8_launches.column_intensity": 640, "socs_cache.hits": 10}
TRACE = {"busy_s": 1.0, "window_s": 2.0}
EXPECTED = {"simulate_lead_ms": 5.0, "int8_launches_per_image.mpx": 256.0,
            "int8_launches_per_image.chip": 256.0, "tile_enqueue_ms": 3.0,
            "queue_wait_ms": 20.0, "serve_wire_ms": 6.0,
            "batch_ms_per_image": 10.0}


@pytest.fixture
def synthetic(monkeypatch):
    from lithographysimulator_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recording", lambda: {
        "spans": SPANS, "counters": COUNTERS, "dropped": 0})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_on_a_synthetic_recording(synthetic, name):
    run = {"trace": TRACE, "window": {"socs_images": 10}}
    assert _reader(name).read(run) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_reads_nothing_untraced_or_without_the_recording(
        synthetic, monkeypatch, name):
    assert _reader(name).read({"trace": None,
                               "window": {"socs_images": 10}}) is None
    # a port whose profiling module has no recording (an older checkout)
    monkeypatch.setitem(sys.modules,
                        "lithographysimulator_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert _reader(name).read({"trace": TRACE,
                               "window": {"socs_images": 10}}) is None


def test_the_readers_read_the_ports_own_recording():
    """A traced CPU simulate and tiled call: the readers find the port's
    spans (no int8 launch on the CPU: its plain versions count none)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.utils import profiling

    cfg = lt.OpticsConfig(pixel_number=32)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    mask = lt.demo_bars(cfg, device="cpu")
    lt.simulate(mask, src, device="cpu", solver="socs", socs_rank=8)
    socs = lt.randomized_socs(lt.pupil_function(np.zeros(5), cfg, device="cpu"),
                              src, cfg, rank=8)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        lt.simulate(mask, src, device="cpu", solver="socs", socs_rank=8)
        lt.tiled_socs_image(np.ones((48, 48), np.float32), socs, cfg, halo=8)
    run = {"trace": TRACE, "window": {"socs_images": 2}}
    assert _reader("simulate_lead_ms").read(run) > 0
    assert _reader("tile_enqueue_ms").read(run) > 0
    assert _reader("int8_launches_per_image.mpx").read(run) == 0
    assert _reader("queue_wait_ms").read(run) is None
