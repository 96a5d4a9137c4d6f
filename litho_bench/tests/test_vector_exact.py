"""The vector exact cell (``arfi1024.vector_exact``): a whole small run on
the CPU, its comparison's controls, the roofline count and the readers of
its per-layer metrics.

The controls are the program with one part of its model or precision
taken away, each judged as a run is, against the float64 vector reference
(``reference/vector.py``):

* the two-limb int8 exact engine (``int8_fast``), the program's own lower
  precision;
* the z component of the field left out;
* the pupil's edge at 1/lambda (today's default convention) in place of
  NA/lambda;
* the scalar image.

Each has to exceed at least one of the configuration's limits, and the
program has to stay under both. On the CPU they run at 256^2 through the
port's plain kernel versions (the windowed int8 path needs every source
shift within n/4 - 2, which 256^2 is the least grid to give at sigma 0.97);
on a card at the cell's own 1024^2, with the reference also in complex64
(TF32 off, the configuration's precision) and with TF32 on (the precision
below it), over three seeds:
``python -m pytest litho_bench/tests/test_vector_exact.py -m cuda -s``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, load

SEEDS = (2**31 + 3, 911, 2**33 + 17)
CELL = "arfi1024.vector_exact"
SMALL_LAYOUT = {"block_px": 32, "min_px": 4, "max_width_px": 6,
                "max_space_px": 8, "max_contact_px": 8}


def _config(n: int | None = None) -> dict:
    cfg = load(ROOT / "litho_bench" / "configs" / "arfi1024.json")
    if n is not None:
        cfg = dict(cfg, pixel_number=n, layout=SMALL_LAYOUT)
    return cfg


def _driver():
    from litho_bench import harness

    return harness.driver_of("exact_stream", ROOT / "litho_bench")


def _controls(cfg: dict, geometry: torch.Tensor, device: str, program: str):
    """{name: image} of the program (``program``: 'simulate', the cell's
    call, or an engine name) and of each control, for one mask."""
    from litho_bench import program as prog
    from litho_bench.reference import vector as rv
    from lithographysimulator_tpu_torch.ops import abbe as pa
    from lithographysimulator_tpu_torch.ops import vector as pv

    lt = prog.lt()
    oc = _driver().optics(cfg)
    ab = prog.aberrations(cfg)
    src = rv.dipole_source(cfg)
    pts = pa.source_points(src)
    shifts, weights = pa._pad_points(pts.shifts, pts.weights, 4)
    spec = lt.mask_spectrum(geometry, oc)
    pupil = lt.pupil_function(ab, oc, device=device)
    kw = dict(device=device, max_abs_shift=int(np.abs(shifts).max()))

    def vector(engine):
        return pv.vector_abbe_image(spec, pupil, shifts, weights, oc,
                                    polarization=cfg["polarization"],
                                    engine=engine, **kw)

    def simulate(optics, polarization):
        return lt.simulate(lt.Mask(geometry=geometry, config=optics), src, ab,
                           solver="gau23", polarization=polarization,
                           device=device).image

    comps = pv.vector_pupils(pupil, oc, rv.STATES[cfg["polarization"]][0][1])
    engine = "int8" if program == "simulate" else program
    return {
        "program": (simulate(oc, cfg["polarization"]) if program == "simulate"
                    else vector(program)),
        "int8_fast": vector("int8_fast"),
        "no z": sum(pa.abbe_image_points(spec, comps[c], shifts, weights, oc,
                                         engine=engine, **kw) for c in (0, 1)),
        "1/lambda edge": simulate(
            dataclasses.replace(oc, pupil_at_na=False),
            cfg["polarization"]),
        "scalar": simulate(oc, None),
    }


def _readings(cfg: dict, images: dict, ref) -> dict:
    from litho_bench import judge
    from litho_bench.reference import optics as ro

    return {name: (ro.nrms(img, ref), judge.broadband(cfg, img, ref))
            for name, img in images.items()}


def _fails(cfg: dict, reading) -> bool:
    limits = cfg["limits"]
    return (reading[0] > limits["image_nrms"]
            or reading[1] > limits["broadband_nrms"])


def test_a_whole_small_run_is_correct_and_reads_its_metrics(tiny_bench):
    from litho_bench import harness

    root, bench_dir, bench = tiny_bench
    for trace in (False, True):
        out = harness.run(bench, root, CELL, 2**31 + 29, 0.3, trace,
                          device="cpu", t_start=time.perf_counter(),
                          bench_dir=bench_dir)
        assert out["correct"] is True and out["attempted"] > 0
        assert set(out["checks"]) == {"image_nrms", "broadband_nrms"}
    # the CPU's plain kernel versions launch nothing; the fields are counted
    assert out["metrics"]["int8_launches_per_field"]["value"] == 0.0
    assert "device_idle_pct.vector" in out["metrics"]


def test_the_controls_fail_on_cpu():
    from litho_bench import masks
    from litho_bench.reference import vector as rv

    cfg = _config(256)
    geometry = masks.layouts(SEEDS[0], 0, 1, 256, cfg["layout"], device="cpu")[0]
    ref = rv.image(geometry, rv.dipole_source(cfg), cfg, cfg["polarization"])
    readings = _readings(cfg, _controls(cfg, geometry, "cpu", "int8"), ref)
    assert not _fails(cfg, readings.pop("program")), readings
    for name, reading in readings.items():
        assert _fails(cfg, reading), (name, reading)


@pytest.mark.cuda
def test_the_controls_fail_on_the_card(card):
    from litho_bench import masks
    from litho_bench.reference import vector as rv

    cfg = _config()
    src = rv.dipole_source(cfg)
    for seed in SEEDS:
        pool = masks.layouts(seed, 0, 16, cfg["pixel_number"], cfg["layout"],
                             device=card)
        order = masks.rng_for(seed, 1).permutation(16).tolist()
        for i in order[:4]:
            t0 = time.perf_counter()
            ref = rv.image(pool[i], src, cfg, cfg["polarization"],
                           block=cfg["vector_reference"]["block"])
            torch.cuda.synchronize()
            t_ref = time.perf_counter() - t0
            images = _controls(cfg, pool[i], card, "simulate")
            images["reference complex64"] = rv.image(
                pool[i], src, cfg, cfg["polarization"], dtype=torch.complex64)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                images["reference TF32"] = rv.image(
                    pool[i], src, cfg, cfg["polarization"], dtype=torch.complex64)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            readings = _readings(cfg, images, ref)
            print(f"seed {seed} mask {i}: reference {t_ref:.2f} s; " + "; ".join(
                f"{k} {v[0]!r} {v[1]!r}" for k, v in readings.items())
                + f"; limits {cfg['limits']!r}", flush=True)
            assert not _fails(cfg, readings.pop("program"))
            readings.pop("reference complex64")
            for name, reading in readings.items():
                assert _fails(cfg, reading), name


def test_the_sample_is_the_seeded_order_of_what_the_window_completed():
    drv = _driver()
    state = {"order": [5, 0, 9, 2, 7]}
    record = {"kept": {0: "a", 2: "b", 7: "c", 8: "d"}}
    assert drv.sampled(state, record, 2) == [0, 2]
    assert drv.sampled(state, record, 4) == [0, 2, 7]


def test_abbe_apply_count_holds_to_the_kernel_table():
    """A chunk of 4 fields at 1024^2 costs the (4, 1024, 520) rows of the
    port's kernel table: row_limb_gemm 0.0201 ms and column_intensity
    0.0397 ms at their bounds; the configuration's 36,168 fields an image
    0.541 s."""
    from litho_bench.reference import vector as rv
    from litho_bench.rooflines import abbe_apply as a
    from litho_bench.rooflines import socs_apply as s

    assert a.window_width(1024) == 520
    chunk, which = a.least_s(4, 1, 1024)
    table = sum(s.kernel_bound_s(k, 4, 1024, 520)[0]
                for k in ("row_limb_gemm", "column_intensity"))
    assert which == "ops" and chunk == pytest.approx(table, rel=1e-12)
    assert round(1e3 * chunk, 4) == round(0.0201 + 0.0397, 4)
    fields, passes = _driver().fields_per_image(_config(), rv.dipole_source(_config()))
    assert (fields, passes) == (36_168, 3)
    least, which = a.least_s(fields, passes, 1024)
    assert which == "ops" and round(least, 3) == 0.541


MS = 1_000_000


def _span(name, start_ms, end_ms, sid):
    return {"name": name, "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS),
            "thread": 1, "id": sid, "parent": None, "request": None, "attrs": {}}


SPANS = [_span("litho.abbe.setup", 0, 2, 1), _span("litho.abbe.setup", 5, 8, 2),
         _span("litho.abbe.setup", 10, 20, 3), _span("litho.simulate", 0, 40, 4)]
COUNTERS = {"int8_launches.window_product_limbs": 30,
            "int8_launches.row_limb_gemm": 30, "int8_launches.row_requantize": 30,
            "int8_launches.column_intensity": 30, "abbe.fields": 120}
EXPECTED = {"abbe_setup_ms": 3.0, "int8_launches_per_field": 1.0}


@pytest.fixture
def synthetic(monkeypatch):
    from lithographysimulator_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recording", lambda: {
        "spans": SPANS, "counters": COUNTERS, "dropped": 0})


def _reader(name):
    from litho_bench import harness

    return harness.reader_of(name, ROOT / "litho_bench")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_new_reader_on_a_synthetic_recording(synthetic, name):
    run = {"trace": {"busy_s": 1.0, "window_s": 2.0}, "window": {}}
    assert _reader(name).read(run) == pytest.approx(EXPECTED[name], rel=1e-12)
    assert _reader(name).read({"trace": None, "window": {}}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_new_reader_reads_nothing_from_a_port_without_its_span(monkeypatch, name):
    """The parent's recording has neither the span nor the field counter."""
    from lithographysimulator_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recording", lambda: {
        "spans": SPANS[3:], "counters": {k: v for k, v in COUNTERS.items()
                                         if k != "abbe.fields"}, "dropped": 0})
    run = {"trace": {"busy_s": 1.0, "window_s": 2.0}, "window": {}}
    assert _reader(name).read(run) is None


def test_the_roofline_reader():
    from litho_bench.rooflines import abbe_apply as a

    window = {"abbe_fields": 36_168, "abbe_passes": 3, "abbe_n": 1024}
    run = {"trace": {"busy_s": 2.0, "window_s": 2.5}, "window": window}
    least, _ = a.least_s(36_168, 3, 1024)
    assert _reader("abbe_roofline.vector").read(run) == pytest.approx(
        100 * least / 2.0)
    assert _reader("abbe_roofline.vector").read({"trace": None, "window": window}) is None
