"""The port's spans and counters (``_spans``, re-exported by
``utils.profiling``) on the CPU: nothing is recorded while no profiler
runs; under ``torch.profiler`` each span enters the trace as a host event
and the recording on the trace's clock, nested under its parent; the
recording is bounded; the pipeline's and the tiling's spans and the SOCS
kernel-set cache's counts; what a span costs with no profiler running."""

import importlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

import lithographysimulator_tpu_torch as lt
from lithographysimulator_tpu_torch import _spans
from lithographysimulator_tpu_torch.ops.tiled import tile_layout
from lithographysimulator_tpu_torch.utils import profiling

psim = importlib.import_module("lithographysimulator_tpu_torch.simulate")

CFG = lt.OpticsConfig(pixel_number=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _traced(fn):
    """``fn()`` under a CPU profiler, from an empty recording: (the
    profiler, the recording)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, profiling.recording()


def _by_name(rec) -> dict:
    out = {}
    for s in rec["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_spans_nest_with_their_parents():
    def work():
        with profiling.span("litho.a", size=3) as a:
            a.set(requests=[1, 2])
            with profiling.span("litho.a.b"):
                with profiling.span("litho.a.b.c"):
                    pass
            with profiling.span("litho.a.d"):
                pass

    _, rec = _traced(work)
    got = {name: s for name, (s,) in _by_name(rec).items()}
    assert set(got) == {"litho.a", "litho.a.b", "litho.a.b.c", "litho.a.d"}
    assert got["litho.a"]["parent"] is None
    assert got["litho.a"]["attrs"] == {"size": 3, "requests": [1, 2]}
    assert got["litho.a.b"]["parent"] == got["litho.a"]["id"]
    assert got["litho.a.d"]["parent"] == got["litho.a"]["id"]
    assert got["litho.a.b.c"]["parent"] == got["litho.a.b"]["id"]
    assert len({s["thread"] for s in got.values()}) == 1
    for s in got.values():
        assert s["start_ns"] <= s["end_ns"] and s["request"] is None
    assert got["litho.a"]["start_ns"] <= got["litho.a.b"]["start_ns"]
    assert got["litho.a.d"]["end_ns"] <= got["litho.a"]["end_ns"]


def test_nothing_is_recorded_without_a_profiler():
    counts = profiling.Counters("test", ("calls",))
    profiling.reset()
    with profiling.span("litho.off") as s:
        s.set(size=1)
        counts.add("calls")
    assert profiling.stamp() is None
    profiling.end_span("litho.off.cross", time.time_ns())
    assert profiling.recording() == {"spans": [], "counters": {}, "dropped": 0}
    assert counts.totals == {"calls": 1}

    def on():
        with profiling.span("litho.on"):
            counts.add("calls", 2)
        profiling.end_span("litho.on.cross", profiling.stamp(), thread=7,
                           request=9)

    _, rec = _traced(on)
    names = _by_name(rec)
    assert set(names) == {"litho.on", "litho.on.cross"}
    (cross,) = names["litho.on.cross"]
    assert (cross["thread"], cross["request"]) == (7, 9)
    assert rec["counters"] == {"test.calls": 2}
    assert counts.snapshot() == {"calls": 3}


def test_spans_enter_the_profiler_trace_on_its_clock():
    """Each span is a host event of the trace, of function scope (not a
    user annotation, whose range the profiler also lays on the device's
    timeline). The recorded span lies inside its event, within 50 us at
    either end, and its ends agree with the event's within 50 us (the
    median over 50 spans: a thread preempted between the event's stamp
    and the span's delays that one span's, inside the event still)."""

    def work():
        for i in range(50):
            with profiling.span(f"litho.clock.{i}"):
                sum(range(100))

    prof, rec = _traced(work)
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("litho.")}
    assert len(rec["spans"]) == len(events) == 50
    starts, ends = [], []
    for s in rec["spans"]:
        ev = events[s["name"]]
        assert ev.device_type() == torch.autograd.DeviceType.CPU
        assert not ev.is_user_annotation()
        assert ev.start_ns() - 50_000 <= s["start_ns"] <= s["end_ns"] \
            <= ev.end_ns() + 50_000
        starts.append(abs(ev.start_ns() - s["start_ns"]))
        ends.append(abs(ev.end_ns() - s["end_ns"]))
    assert np.median(starts) <= 50_000 and np.median(ends) <= 50_000


def test_the_recording_is_bounded(monkeypatch):
    monkeypatch.setattr(_spans, "MAX_SPANS", 5)

    def work():
        for _ in range(8):
            with profiling.span("litho.many"):
                pass

    _, rec = _traced(work)
    assert len(rec["spans"]) == 5 and rec["dropped"] == 3
    profiling.reset()
    assert profiling.recording()["dropped"] == 0


def test_request_scope_gives_its_id_to_the_spans_inside():
    def work():
        with profiling.request_scope() as outer:
            with profiling.span("litho.req.a"):
                pass
            with profiling.request_scope() as inner:
                with profiling.span("litho.req.b"):
                    assert profiling.current_request() == inner.id
            with profiling.span("litho.req.c"):
                pass
        assert profiling.current_request() is None
        return outer.id, inner.id

    ids = []
    _, rec = _traced(lambda: ids.extend(work()))
    got = {s["name"]: s["request"] for s in rec["spans"]}
    assert got == {"litho.req.a": ids[0], "litho.req.b": ids[1],
                   "litho.req.c": ids[0]}
    assert ids[0] != ids[1]


def test_trace_writes_the_spans_beside_its_trace(tmp_path):
    """trace() starts from an empty recording and writes it as spans.json;
    annotate routes through span; 'bench.' names are the benchmark's."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("litho.before"):
            pass

    @profiling.annotate("litho.annotated")
    def double(x):
        return 2 * x

    with profiling.trace(tmp_path / "t"):
        double(torch.ones(2))
    written = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert [s["name"] for s in written["spans"]] == ["litho.annotated"]
    assert "litho.annotated" in (tmp_path / "t" / "trace.json").read_text()
    with pytest.raises(ValueError, match="bench"):
        profiling.annotate("bench.window")


def test_simulate_spans_and_the_cache_counts(monkeypatch):
    """Two SOCS simulate calls on an empty cache: one miss, then one hit,
    in the totals and, for the traced call, in the recording (with its
    key's reuse and its bound from the entry); the traced
    call's spans are the pipeline's, each under the root."""
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE", {})
    src = lt.LightSource(CFG, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    mask = lt.demo_bars(CFG, device="cpu")
    before = psim.socs_cache_counts()
    lt.simulate(mask, src, device="cpu", solver="socs", socs_rank=8)
    after_first = psim.socs_cache_counts()
    assert after_first["misses"] == before["misses"] + 1
    assert after_first["hits"] == before["hits"]
    _, rec = _traced(lambda: lt.simulate(mask, src, device="cpu",
                                         solver="socs", socs_rank=8))
    after = psim.socs_cache_counts()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"] + 1
    # the warm call reuses the source map's key and the entry's bound terms
    assert rec["counters"] == {"socs_cache.hits": 1,
                               "socs_cache.key_reuses": 1,
                               "socs_cache.bound_from_entry": 1}
    names = _by_name(rec)
    assert set(names) == {"litho.simulate", "litho.simulate.inputs",
                          "litho.simulate.kernels", "litho.simulate.spectrum",
                          "litho.simulate.apply", "litho.simulate.bound"}
    (root,) = names["litho.simulate"]
    for name, spans in names.items():
        if name != "litho.simulate":
            assert [s["parent"] for s in spans] == [root["id"]]
    order = ["inputs", "kernels", "spectrum", "apply", "bound"]
    starts = [names[f"litho.simulate.{o}"][0]["start_ns"] for o in order]
    assert starts == sorted(starts)

    geos = torch.stack([mask.geometry, mask.geometry])
    _, rec = _traced(lambda: lt.simulate_batch(geos, CFG, src, device="cpu",
                                               solver="socs", socs_rank=8))
    names = _by_name(rec)
    assert set(names) == {"litho.simulate_batch",
                          "litho.simulate_batch.kernels"}
    assert names["litho.simulate_batch.kernels"][0]["parent"] == \
        names["litho.simulate_batch"][0]["id"]


def test_tiled_spans():
    """A 96^2 chip through 64^2 tiles: one call, its padding, a span a tile
    with the tile's spectrum and apply inside, and the final crop."""
    cfg = lt.OpticsConfig(pixel_number=64)
    src = lt.LightSource(cfg, sigma_in=0.2).classical()
    socs = lt.randomized_socs(lt.pupil_function(np.zeros(5), cfg, device="cpu"),
                              src, cfg, rank=8)
    chip = np.zeros((96, 96), np.float32)
    chip[20:70, 40:48] = 1.0
    _, rec = _traced(lambda: lt.tiled_socs_image(chip, socs, cfg, halo=16))
    names = _by_name(rec)
    tiles = tile_layout(96, 64, 16)[0] ** 2
    assert {k: len(v) for k, v in names.items()} == {
        "litho.tiled": 1, "litho.tiled.pad": 1, "litho.tiled.tile": tiles,
        "litho.tiled.tile.spectrum": tiles, "litho.tiled.tile.apply": tiles,
        "litho.tiled.finish": 1}
    root = names["litho.tiled"][0]["id"]
    tile_ids = {s["id"] for s in names["litho.tiled.tile"]}
    for name in ("litho.tiled.pad", "litho.tiled.tile", "litho.tiled.finish"):
        assert {s["parent"] for s in names[name]} == {root}
    for name in ("litho.tiled.tile.spectrum", "litho.tiled.tile.apply"):
        assert {s["parent"] for s in names[name]} == tile_ids


def test_the_port_names_its_spans_litho():
    """Every span the port records carries the ``litho.`` prefix (none a
    ``bench.`` one): the names the benchmark's readers look for."""
    cfg = lt.OpticsConfig(pixel_number=16)
    src = lt.LightSource(cfg, sigma_in=0.2).classical()
    _, rec = _traced(lambda: lt.simulate(lt.demo_bars(cfg, device="cpu"), src,
                                         device="cpu"))
    assert rec["spans"] and all(s["name"].startswith("litho.")
                                for s in rec["spans"])


def test_a_span_costs_little_with_no_profiler_running():
    """The cost with no profiler running, over 1e5 spans (the real figure,
    on the card's host, is in PERF.md; this bound only catches a span that
    does work while off)."""
    n = 100_000
    span = profiling.span
    t0 = time.perf_counter()
    for _ in range(n):
        with span("litho.cost"):
            pass
    assert (time.perf_counter() - t0) / n < 20e-6
